"""The benchmark's core: it finds a cell's files by the names in
``BENCHMARK.json``, checks the card and the imports, runs the cell's driver
through set-up, the measured window and the check, reads every metric with
its reader, and prints the one result line.

Files found by name (a later cell, configuration or metric adds files and
edits none):

* ``bench/configs/<config>.json``: the configuration as it is run; its
  ``reference`` names the plain reference in ``bench/references/``;
* ``bench/traffic/<traffic>.json``: the mix; its ``driver`` names the
  driver in ``bench/drivers/``;
* ``bench/limits/<workload>.json``: each number the check compares, with
  its limit;
* ``bench/metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the
  metric's value or None when it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names no run may hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that are in
    ``FORBIDDEN``: the part before the first dot, compared whole, so
    ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by name."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str, e2e_here: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, without a
    list, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_here


def find_cell(workload: str, spec: dict | None = None) -> Cell:
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, workload, names)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, layer)


def reader(metric: str):
    """The module ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(traffic: dict):
    return importlib.import_module(
        f"bench.drivers.{traffic['driver']}").Driver


@dataclass
class Window:
    """The measured window on the host's clock: ``begin`` and ``end`` are
    called by the driver at work boundaries.  In a traced run they also
    open and close the ``record_function`` range that marks the window in
    the profiler's trace."""
    traced: bool = False
    start: float | None = None
    stop: float | None = None
    _range: object = None

    def begin(self):
        if self.traced:
            import torch
            from bench.tracing import WINDOW
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        self.start = time.perf_counter()

    def end(self):
        self.stop = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    @property
    def seconds(self) -> float:
        return self.stop - self.start

    def over(self, seconds: float) -> bool:
        return self.start is not None and \
            time.perf_counter() - self.start >= seconds


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number against its limit: correct when every number is
    finite and at most its limit, and every limit has its number."""
    out, ok = {}, True
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok = ok and good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out


def read_metrics(metrics: list, ctx: dict) -> dict:
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def regions_of(metrics: list) -> list:
    regs = []
    for m in metrics:
        r = getattr(reader(m["name"]), "REGION", None)
        if r is not None and r not in regs:
            regs.append(r)
    return regs


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_process: float) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    object (without printing).  ``device`` is the card, or the CPU in the
    harness's own tests."""
    import torch
    from bench import tracing

    regions = regions_of(cell.per_layer) if trace else []
    calls: dict = {}
    undo = tracing.observe(regions, calls) if regions else []
    prof = tracing.profiler() if trace else None
    window = Window(traced=trace)
    drv = driver_class(cell.traffic)(cell.config, cell.traffic, seed, device)
    try:
        drv.setup()
        t_setup = time.perf_counter()
        if prof is not None:
            prof.start()
        drv.run_window(seconds, window)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        summary = None
        if prof is not None:
            summary = tracing.summarize(tracing.events(prof),
                                        [r[0] for r in regions])
    finally:
        for u in undo:
            u()
    mem = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
           else 0)
    ctx = {"setup_s": window.start - t_process, "window": window,
           "seconds": window.seconds, "trace": summary, "calls": calls,
           "config": cell.config, "traffic": cell.traffic,
           "facts": drv.facts(), "peaks": load_json(
               BENCH / "yardstick" / "peaks.json")}
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    attempted, failed = drv.attempted_failed()
    t_check = time.perf_counter()
    numbers = drv.check()
    print(f"[bench] {cell.name}: driver set up at {t_setup - t_process:.2f}"
          f" s, window {window.start - t_process:.2f} s to "
          f"{window.stop - t_process:.2f} s, check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct, compared = judge(numbers, cell.limits)
    # after the window, the readers and the check: whatever any of them
    # loaded is in ``sys.modules`` now
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(mem)}
    if trace:
        dev["busy_s"] = summary["busy_s"] if summary else 0.0
        dev["window_s"] = summary["window_s"] if summary else window.seconds
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and summary:
        result["breakdown"] = tracing.breakdown(summary)
    result["check"] = compared
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules that no run may load: {found}")
        self.found = found
