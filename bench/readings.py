"""The readings a cell's limits are set from: for each seed, one short
window of the cell at its own load, then the check's numbers for the
program and for the control (the reference put in the program's place, in
the precision below the configuration's), all in one process:

    python3 bench/readings.py --workload <name> --seeds 1,2,3 --seconds 10

One JSON line a seed on standard output.  The benchmark's own runs never
run the control.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell, seed: int, seconds: float, device) -> dict:
    """Program and control numbers of one seed."""
    from bench import harness
    drv = harness.driver_class(cell.traffic)(cell.config, cell.traffic, seed,
                                             device)
    t0 = time.perf_counter()
    drv.setup()
    window = harness.Window()
    drv.run_window(seconds, window)
    t1 = time.perf_counter()
    nums = drv.check(control=True)
    return {"seed": seed, "setup_and_window_s": t1 - t0,
            "check_s": time.perf_counter() - t1, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), args.seconds,
                                  torch.device("cuda", 0))), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
