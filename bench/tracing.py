"""What a traced run (``--trace 1``) reads from the device: a
``torch.profiler`` session over the window, regions around program calls
that the per-layer metrics name, and the reduction of the profiler's trace
to busy time, time by kernel, time inside each region and idle time by
what the host was doing.

A reader that needs a region declares ``REGION = (name, module, function)``;
``observe`` wraps that function of the program in
``record_function(name)`` and records each call's shapes, so the region's
device time and the work of its calls are measured around the call, not by
kernel name.
"""
from __future__ import annotations

import bisect
import functools
import heapq
import importlib
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 100


def _arg(v):
    if isinstance(v, torch.Tensor):
        return {"shape": tuple(v.shape), "dtype": str(v.dtype)[6:],
                "itemsize": v.element_size()}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return type(v).__name__


def observe(regions: list, calls: dict) -> list:
    """Wrap each ``(name, module, function)`` of the program; every call
    appends (host time, args, kwargs) to ``calls[name]``.  Returns undo
    callables.  The wrapper keeps the function's attributes (its launch
    counters) in step: it carries a copy of them, and the function counts
    through whatever its module's name refers to."""
    undo = []
    for name, mod_name, fn_name in regions:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        log = calls.setdefault(name, [])

        def wrapper(*args, _fn=fn, _name=name, _log=log, **kwargs):
            _log.append((time.perf_counter(), [_arg(a) for a in args],
                         {k: _arg(v) for k, v in kwargs.items()}))
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        functools.update_wrapper(wrapper, fn)
        setattr(mod, fn_name, wrapper)
        undo.append(functools.partial(setattr, mod, fn_name, fn))
    return undo


def profiler() -> torch.profiler.profile:
    """A profiler over the device and the host; the harness starts it after
    set-up and stops it after the window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def events(prof) -> list:
    """Stop ``prof`` and return its trace's events."""
    prof.stop()
    tmp = Path(tempfile.mkdtemp(prefix="bench-trace-"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def idle_share(ctx) -> float | None:
    """The traced window's share with no kernel, copy or memset running on
    the card, in percent."""
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(intervals, merged) -> float:
    """Total overlap of ``intervals`` with the merged, sorted ``merged``."""
    starts = [m[0] for m in merged]
    total = 0.0
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return total


def summarize(events: list, regions=()) -> dict | None:
    """Reduce a chrome trace to the window's numbers, in seconds:
    ``window_s``, ``busy_s`` (the union of device work inside the window),
    ``kernels``, ``by_kernel`` (device time by name), ``region_s`` (device
    time inside each named region's device-side ranges) and ``idle_by_host``
    (the window's idle device time, each gap named by the innermost host
    event under its midpoint).  None when the trace holds no window."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        return None
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    work, by_kernel = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            work.append((a, b))
            n = e["name"][:NAME_CHARS]
            by_kernel[n] = by_kernel.get(n, 0.0) + (b - a) * 1e-6
    busy = _union(work)
    region_s = {}
    for name in regions:
        marks = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("name") == name
                       and e.get("cat") == "gpu_user_annotation")
        region_s[name] = _overlap(work, marks) * 1e-6 if marks else None
    gaps, end = [], lo
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": len(work), "by_kernel": by_kernel,
            "region_s": region_s,
            "idle_by_host": _name_gaps(gaps, events)}


def _name_gaps(gaps, events) -> dict:
    """Idle seconds by the innermost host event under each gap's midpoint."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    out, active, i = {}, [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            s, e, n = host[i]
            heapq.heappush(active, (e - s, e, n))
            i += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        # the top is the shortest event still open at mid: the innermost
        name = active[0][2][:NAME_CHARS] if active else \
            "host work outside any op"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle totals by host activity, seconds as measured."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(summary["by_kernel"]),
            "idle_gaps": top(summary["idle_by_host"])}
