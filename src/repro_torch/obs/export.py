"""Chrome trace-event export: drain timelines Perfetto can load.

A copy of the JAX package's ``obs/export.py`` (pure Python): importing it
from there would pull in ``repro.obs`` and jax with it.

``chrome_trace`` turns a ``Tracer``'s spans into the Chrome trace-event
JSON format (https://ui.perfetto.dev or ``chrome://tracing`` load it
directly): one complete event (``ph="X"``) per span with microsecond
``ts``/``dur``, plus thread-name metadata so the timeline shows ONE
TRACK PER HOST:

* spans carrying ``host=h`` land on the ``host h`` track — under a
  simulated topology the per-window pack/dispatch/fence spans line up
  per host, which is exactly the lens the "make multi-host actually
  concurrent" ROADMAP item needs (sequential windows show as
  non-overlapping blocks today; a real executor must make them overlap);
* spans carrying ``track="store"`` (shard read/write/flush I/O) get a
  dedicated store track;
* everything else (drain, admission, wave packing for the single-host
  path) sits on the scheduler track.

``metrics_json`` dumps a ``MetricsRegistry`` flat (counters, gauges,
histogram summaries with p50/p90/p99) and ``validate_chrome_trace``
checks the schema CI gates: required keys per event, non-negative
timestamps/durations, and every span inside the drain bounds.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

_SCHEDULER_TID = 0
_HOST_TID_BASE = 1            # host h → tid 1 + h
_STORE_TRACK = "store"

REQUIRED_EVENT_KEYS = ("ph", "ts", "pid", "tid", "name")


def _tid(span_attrs: dict, num_hosts: int) -> int:
    if span_attrs.get("track") == _STORE_TRACK:
        return _HOST_TID_BASE + num_hosts          # after the host tracks
    host = span_attrs.get("host")
    if host is not None:
        return _HOST_TID_BASE + int(host)
    return _SCHEDULER_TID


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.Tensor):            # a count left on the device
        return v.tolist()
    return str(v)


def chrome_trace(tracer: Tracer, *, hosts: int | None = None,
                 pid: int = 0, process_name: str = "synthesis-server",
                 ) -> dict:
    """Build the trace-event JSON object for ``tracer``'s spans.

    ``hosts`` forces at least that many host tracks (a drain that never
    placed a wave still shows its topology); otherwise tracks are
    derived from the ``host=`` attributes seen.  Timestamps are the
    tracer clock converted to integer-rounded microseconds."""
    seen = {int(s.attrs["host"]) for s in tracer.spans
            if s.attrs.get("host") is not None}
    num_hosts = max(hosts or 0, max(seen) + 1 if seen else 0)
    has_store = any(s.attrs.get("track") == _STORE_TRACK
                    for s in tracer.spans)

    events = [{"ph": "M", "pid": pid, "tid": 0, "ts": 0,
               "name": "process_name", "args": {"name": process_name}},
              {"ph": "M", "pid": pid, "tid": _SCHEDULER_TID, "ts": 0,
               "name": "thread_name", "args": {"name": "scheduler"}}]
    for h in range(num_hosts):
        events.append({"ph": "M", "pid": pid, "tid": _HOST_TID_BASE + h,
                       "ts": 0, "name": "thread_name",
                       "args": {"name": f"host {h}"}})
    if has_store:
        events.append({"ph": "M", "pid": pid,
                       "tid": _HOST_TID_BASE + num_hosts, "ts": 0,
                       "name": "thread_name", "args": {"name": "store"}})

    for s in tracer.spans:
        events.append({
            "ph": "X", "pid": pid, "tid": _tid(s.attrs, num_hosts),
            "ts": round(s.start * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "name": s.name,
            "args": {k: _jsonable(v) for k, v in s.attrs.items()
                     if k not in ("track",)},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def metrics_json(registry: MetricsRegistry) -> dict:
    """Flat JSON-able metrics dump (counters/gauges raw, histograms as
    count/sum/min/max/mean/p50/p90/p99 summaries)."""
    return registry.as_dict()


def write_trace(path, tracer: Tracer, *,
                registry: MetricsRegistry | None = None,
                hosts: int | None = None) -> dict:
    """Export ``tracer`` (and optionally a metrics dump) to ``path``.
    Validates the trace before writing, so a malformed export fails the
    producer, not the eventual Perfetto load."""
    obj = chrome_trace(tracer, hosts=hosts)
    if registry is not None:
        obj["metrics"] = metrics_json(registry)
    validate_chrome_trace(obj, require_hosts=hosts)
    Path(path).write_text(json.dumps(obj, indent=1))
    return obj


def validate_chrome_trace(obj: dict, *, require_hosts: int | None = None):
    """Schema gate for exported traces (the CI smoke step runs this on
    the benchmark artifact).  Checks:

    * ``traceEvents`` is a list and every event carries ``ph/ts/pid/tid/
      name`` (complete events additionally ``dur``);
    * timestamps and durations are non-negative numbers;
    * every span lies within the drain bounds (the earliest span start /
      latest span end — a span outside them means a clock went
      backwards or an export mixed clocks);
    * at least ``require_hosts`` named host tracks exist.

    Raises ``ValueError`` naming every violation; returns the event
    count when clean."""
    errors = []
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents list")
    spans = [e for e in events if e.get("ph") == "X"]
    for i, e in enumerate(events):
        for k in REQUIRED_EVENT_KEYS:
            if k not in e:
                errors.append(f"event {i} ({e.get('name')!r}) missing {k!r}")
        if e.get("ph") == "X":
            if "dur" not in e:
                errors.append(f"span {i} ({e.get('name')!r}) missing 'dur'")
            elif not (isinstance(e["dur"], (int, float)) and e["dur"] >= 0):
                errors.append(f"span {i} ({e.get('name')!r}) has negative "
                              f"or non-numeric dur {e['dur']!r}")
        ts = e.get("ts")
        if ts is not None and not (isinstance(ts, (int, float)) and ts >= 0):
            errors.append(f"event {i} ({e.get('name')!r}) has negative or "
                          f"non-numeric ts {ts!r}")
    if spans:
        ok = [e for e in spans if isinstance(e.get("ts"), (int, float))
              and isinstance(e.get("dur"), (int, float))]
        if ok:
            lo = min(e["ts"] for e in ok)
            hi = max(e["ts"] + e["dur"] for e in ok)
            for e in ok:
                if e["ts"] < lo or e["ts"] + e["dur"] > hi:
                    errors.append(f"span {e['name']!r} outside drain "
                                  f"bounds [{lo}, {hi}]")
    else:
        errors.append("trace has no complete ('X') span events")
    if require_hosts:
        tracks = {e["args"]["name"] for e in events
                  if e.get("ph") == "M" and e.get("name") == "thread_name"
                  and isinstance(e.get("args"), dict)
                  and "name" in e["args"]}
        missing = [f"host {h}" for h in range(require_hosts)
                   if f"host {h}" not in tracks]
        if missing:
            errors.append(f"missing host tracks: {missing} "
                          f"(have {sorted(tracks)})")
    if errors:
        raise ValueError("invalid chrome trace: " + "; ".join(errors))
    return len(events)
