"""The program's own spans and counters in a traced run, read as per-layer
metrics beside the harness's:

    python3 bench/spans.py --workload olmoe-prefill-docs --seed 7 --seconds 40

runs one cell as ``run.py --trace 1`` does (set-up, then the window under
the profiler, the harness's regions wrapped), with the program's process
tracer (``repro_torch.obs.trace.default()``) enabled from before the driver
is built, and prints one JSON line: the cell's per-layer metrics as the
harness reads them, the program-span metrics of ``METRICS``, the device
time inside each span of ``SPANS``, and the breakdown, whose idle gaps the
program's spans now name.  It runs no check.  Without a card it fails.

The harness's readers see neither the program's spans nor their device
time: ``harness.drive`` would enable the tracer, hand readers
``ctx["program"]`` (``program_spans``) and sum the device time of a
reader's ``SPANS`` into ``region_s``.  Until it does, these metrics are
read here, each a function of such a ``ctx``, returning None where its
spans are absent (never 0 for a share of a roofline).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, tracing  # noqa: E402
from bench.yardstick import attention  # noqa: E402

#: program spans whose device time the summary reads (``region_s``).  The
#: profiler gives a launch's device time to the innermost range open over
#: it alone, so only spans with no span inside them are read: ``moe`` is
#: its four stages, and a ``REGION`` around a call the program already
#: spans (the harness's ``attention``, ``moe``) reads nothing
SPANS = ("flash_attention", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine", "serve.pad_caches")
#: the MoE's stages other than the experts' products
MOE_GLUE = ("moe.route", "moe.dispatch", "moe.combine")


def program_spans(tracer, window) -> list:
    """The tracer's closed spans and instants that start inside the window
    (both on ``time.perf_counter``): name, start, duration and attributes,
    device counts read as numbers."""
    from repro_torch.obs.trace import resolve
    return [{"name": s.name, "start": s.start, "duration": s.duration,
             "attrs": resolve(s.attrs)}
            for s in list(tracer.spans)
            if window.start <= s.start < window.stop]


def _named(ctx, name) -> list:
    return [s for s in ctx.get("program") or () if s["name"] == name]


def _device_share(ctx, seconds) -> float | None:
    tr = ctx["trace"]
    if not tr or not tr["busy_s"] or seconds is None:
        return None
    return 100.0 * seconds / tr["busy_s"]


def wave_gap_ms(ctx) -> float | None:
    """Mean ``gap_ms`` of the window's ``wave.device`` instants: the card's
    idle time between a wave's end and the next one's start, on its own
    clock."""
    gaps = [s["attrs"]["gap_ms"] for s in _named(ctx, "wave.device")
            if "gap_ms" in s["attrs"]]
    return sum(gaps) / len(gaps) if gaps else None


def boundary_host_ms(ctx) -> float | None:
    """Host milliseconds in ``wave.admit`` and ``wave.pack`` a wave: the
    synthesis engine's work at a wave boundary, without the launch
    queue's wait."""
    packs = _named(ctx, "wave.pack")
    admits = _named(ctx, "wave.admit")
    if not packs or not admits:
        return None
    return 1e3 * sum(s["duration"] for s in packs + admits) / len(packs)


def attention_span_roofline(ctx) -> float | None:
    """The least time of the window's ``flash_attention`` calls, from the
    shapes on their spans, over the device time inside those spans, in
    percent."""
    calls = _named(ctx, "flash_attention")
    tr = ctx["trace"]
    dev = tr["region_s"].get("flash_attention") if tr else None
    if not calls or not dev:
        return None
    least = sum(attention.least_seconds(c["attrs"], ctx["peaks"])
                for c in calls)
    return 100.0 * least / dev


def moe_glue_device_share(ctx) -> float | None:
    """Device time in the MoE less that in ``moe.experts``: in
    ``moe.route``, ``moe.dispatch`` and ``moe.combine`` (routing, the index
    lists, gathers and the combine), over busy time, in percent."""
    tr = ctx["trace"]
    glue = [tr["region_s"].get(n) for n in MOE_GLUE] if tr else [None]
    if None in glue:
        return None
    return _device_share(ctx, sum(glue))


def moe_padded_row_share(ctx) -> float | None:
    """1 − Σ(pairs − dropped) / Σ expert_rows over the window's
    ``moe.dispatch`` spans: the expert rows that hold no routed pair, in
    percent."""
    ds = _named(ctx, "moe.dispatch")
    rows = sum(s["attrs"]["expert_rows"] for s in ds)
    if not rows:
        return None
    used = sum(s["attrs"]["pairs"] - s["attrs"]["dropped"] for s in ds)
    return 100.0 * (1.0 - used / rows)


def cache_pad_device_share(ctx) -> float | None:
    """Device time in ``serve.pad_caches`` over busy time, in percent."""
    tr = ctx["trace"]
    return _device_share(ctx, tr["region_s"].get("serve.pad_caches")
                         if tr else None)


#: metric name → (reader, the end-to-end metric it moves)
METRICS = {
    "dsyn.wave_gap_ms": (wave_gap_ms, "dsyn_images_per_s"),
    "dsyn.boundary_host_ms": (boundary_host_ms, "dsyn_images_per_s"),
    "dsyn.attention_span_roofline": (attention_span_roofline,
                                     "dsyn_images_per_s"),
    "prefill.attention_span_roofline": (attention_span_roofline,
                                        "prefill_tokens_per_s"),
    "prefill.moe_glue_device_share": (moe_glue_device_share,
                                      "prefill_tokens_per_s"),
    "prefill.moe_padded_row_share": (moe_padded_row_share,
                                     "prefill_tokens_per_s"),
    "prefill.cache_pad_device_share": (cache_pad_device_share,
                                       "prefill_tokens_per_s"),
}


def drive(cell: harness.Cell, seed: int, seconds: float, device,
          t_process: float) -> dict:
    """One traced run of ``cell`` with the program's tracer on: the
    harness's per-layer metrics, ``METRICS`` of the cell's end-to-end
    metrics, each span's device seconds, and the breakdown."""
    import torch
    from repro_torch.obs.trace import default

    regions = harness.regions_of(cell.per_layer)
    calls: dict = {}
    undo = tracing.observe(regions, calls)
    tracer = default()
    was = tracer.enabled
    tracer.enabled = True
    prof = tracing.profiler()
    window = harness.Window(traced=True)
    try:
        drv = harness.driver_class(cell.traffic)(cell.config, cell.traffic,
                                                 seed, device)
        drv.setup()
        prof.start()
        drv.run_window(seconds, window)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        summary = tracing.summarize(tracing.events(prof),
                                    [r[0] for r in regions] + list(SPANS))
    finally:
        tracer.enabled = was
        for u in undo:
            u()
    ctx = {"setup_s": window.start - t_process, "window": window,
           "seconds": window.seconds, "trace": summary, "calls": calls,
           "config": cell.config, "traffic": cell.traffic,
           "facts": drv.facts(), "peaks": harness.load_json(
               harness.BENCH / "yardstick" / "peaks.json"),
           "program": program_spans(tracer, window)}
    e2e = {m["name"] for m in cell.end_to_end}
    spans = {}
    for name, (read, moves) in METRICS.items():
        v = read(ctx) if moves in e2e else None
        if v is not None:
            spans[name] = v
    found = harness.forbidden_modules()
    if found:
        raise harness.ForbiddenImport(found)
    return {"metrics": harness.read_metrics(cell.per_layer, ctx),
            "spans": spans,
            "span_device_s": {n: summary["region_s"][n] for n in SPANS}
            if summary else {},
            "program_spans": len(ctx["program"]),
            "device": {"kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "busy_s": summary["busy_s"] if summary else 0.0,
                       "window_s": summary["window_s"] if summary
                       else window.seconds},
            "breakdown": tracing.breakdown(summary) if summary else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = drive(harness.find_cell(args.workload), args.seed % 2 ** 64,
                args.seconds, torch.device("cuda", 0), T_PROCESS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
