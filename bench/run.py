"""Run one cell of the benchmark of ``repro_torch`` on the card:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It loads and warms the cell (set-up), measures
for ``--seconds`` seconds, checks what the window produced against the plain
reference, and prints one JSON object as the last line of standard output,
each compared number beside its limit as the last lines of standard error.
With ``--trace 1`` the metrics are the cell's per-layer metrics, read from a
``torch.profiler`` trace of the window.  It fails, printing no result,
without a CUDA card (it never falls back to the CPU), without the program,
or when a module of the JAX package is loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    found = harness.forbidden_modules()
    if found:
        print(f"refusing to run: {found} loaded", file=sys.stderr)
        return 3
    import torch
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    try:
        result = harness.drive(cell, args.seed % 2 ** 64, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_PROCESS)
    except harness.ForbiddenImport as e:
        print(f"modules that no run may load were loaded: {e.found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
