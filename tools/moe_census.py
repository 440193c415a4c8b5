#!/usr/bin/env python3
"""Which expert pass each MoE layer of a benchmark cell took, and how often
each compact-pass kernel launched, against the cell's waves:

    python3 tools/moe_census.py --workload olmoe-prefill-docs --seed 7 --seconds 40

runs the cell's driver as ``bench/run.py`` does (set-up, then the window)
with the program's process tracer (``repro_torch.obs.trace.default()``)
enabled from before the driver is built, and prints one JSON line: the
engine's waves in the window, the model's MoE layers, their product (the
MoE layer passes the window should hold), the window's ``moe.experts``
spans counted by their ``path`` attribute, and the launches of
``kernels/moe/ops.py``'s three wrappers inside the window.  It runs no
check and reads no profiler.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WRAPPERS = ("expert_up", "expert_down", "combine")


def census(workload: str, seed: int, seconds: float) -> dict:
    import torch

    from bench import harness
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.obs.trace import default

    def launches() -> dict:
        return {n: getattr(moe_ops, n).launches for n in WRAPPERS}

    cell = harness.find_cell(workload)
    device = torch.device("cuda", 0)
    tracer = default()
    tracer.enabled = True
    drv = harness.driver_class(cell.traffic)(cell.config, cell.traffic, seed,
                                             device)
    drv.setup()
    window = harness.Window()
    before = launches()
    drv.run_window(seconds, window)
    torch.cuda.synchronize(device)
    after = launches()
    tracer.enabled = False
    paths = collections.Counter(
        s.attrs.get("path") for s in tracer.spans
        if s.name == "moe.experts" and window.start <= s.start < window.stop)
    layers = sum(1 for layer in drv.lm.layers
                 if getattr(layer, "moe", None) is not None)
    waves = drv.facts()["waves"]
    return {"workload": workload, "seed": seed, "window_s": window.seconds,
            "waves": waves, "moe_layers": layers,
            "moe_layer_passes": layers * waves,
            "moe_experts_spans": dict(paths),
            "launches": {n: after[n] - before[n] for n in WRAPPERS},
            "device": torch.cuda.get_device_name(device)}


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
    print(json.dumps(census(args.workload, args.seed % 2 ** 64,
                            args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
