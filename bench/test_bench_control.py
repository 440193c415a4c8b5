"""On the card: the control (the reference put in the program's place in
the precision below the configuration's: TF32 products for the float32
DiT, float8 operands for the bf16 LM) must fail a limit that the program
passes, on a short window of each cell at its own widths, with a smaller
sample.  Run with ``python -m pytest -m cuda bench/test_bench_control.py``
on a machine with the card."""
import pytest

from bench import harness, readings

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload):
    cell = harness.find_cell(workload)
    cell.traffic = dict(cell.traffic, check_requests=2)
    nums = readings.readings(cell, 2 ** 31 + 77, 2.0, card)
    assert harness.judge(nums["program"], cell.limits)[0], nums["program"]
    assert not harness.judge(nums["control"], cell.limits)[0], \
        nums["control"]
