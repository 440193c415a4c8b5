"""Rate arithmetic: the end-to-end rates count whole waves or whole batches
inside the window, over the window's seconds, including a stall inside it."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.test_bench_faults import tiny

CPU = torch.device("cpu")


def read(metric, facts, seconds):
    ctx = {"facts": facts, "seconds": seconds, "setup_s": 1.5}
    return harness.reader(metric).read(ctx)


def test_rate_readers_by_hand():
    assert read("dsyn_images_per_s", {"images": 240}, 40.0) == 6.0
    assert read("prefill_tokens_per_s", {"lengths": [1, 2], "tokens": 3},
                0.5) == 6.0
    assert read("dsyn_images_per_s", {"lengths": []}, 1.0) is None
    assert read("setup_s", {}, 1.0) == 1.5


def _window_with_stall(cell, stall_at: int, stall_s: float):
    """Drive the cell's window with the host stalled once, at the
    ``stall_at``-th boundary (wave or batch) inside the window."""
    drv = harness.driver_class(cell.traffic)(cell.config, cell.traffic, 3,
                                             CPU)
    drv.setup()
    w = harness.Window()
    seen = {"n": 0}
    over = w.over

    def stalled(seconds):
        seen["n"] += w.start is not None
        if seen["n"] == stall_at:
            time.sleep(stall_s)
        return over(seconds)

    w.over = stalled
    drv.run_window(0.4, w)
    return drv, w


@pytest.mark.parametrize("stall", [0.0, 0.5])
def test_dsyn_window_counts_whole_waves(stall):
    cell = tiny("dit224-uniform")
    drv, w = _window_with_stall(cell, 1, stall)
    f = drv.facts()
    assert f["waves"] >= 1
    assert f["images"] == f["waves"] * cell.traffic["wave_images"]
    assert w.seconds >= stall
    ctx = {"facts": f, "seconds": w.seconds}
    assert harness.reader("dsyn_images_per_s").read(ctx) == \
        pytest.approx(f["images"] / w.seconds)


@pytest.mark.parametrize("stall", [0.0, 0.5])
def test_prefill_window_counts_whole_batches(stall):
    cell = tiny("olmoe-prefill-docs")
    drv, w = _window_with_stall(cell, 1, stall)
    f = drv.facts()
    assert f["batches"] >= 1
    assert f["tokens"] == f["batches"] * sum(n * c for n, c in cell.traffic["batch"])
    assert f["waves"] == f["batches"] * len(cell.traffic["batch"])
    assert w.seconds >= stall
    ctx = {"facts": f, "seconds": w.seconds}
    assert harness.reader("prefill_tokens_per_s").read(ctx) == \
        pytest.approx(f["tokens"] / w.seconds)


def test_window_over_waits_for_its_start():
    w = harness.Window()
    assert not w.over(0.0)
    w.begin()
    assert w.over(0.0) and not w.over(60.0)
    time.sleep(0.01)
    w.end()
    assert w.seconds >= 0.01


def test_padded_share_and_mfu_readers():
    st = {"begin": {"row_iters_active": 100, "row_iters_scheduled": 100},
          "end": {"row_iters_active": 175, "row_iters_scheduled": 200}}
    ctx = {"facts": {"stats": st}, "seconds": 2.0,
           "config": harness.load_json(harness.BENCH / "configs" /
                                       "oscar-dit-224.json"),
           "peaks": {"flops_per_s": {"float32": 1e12}},
           "window": SimpleNamespace(start=0, stop=2)}
    assert harness.reader("dsyn.padded_row_iter_share").read(ctx) == \
        pytest.approx(25.0)
    from bench.yardstick import dit
    want = 100 * 75 * 2 * dit.row_call_flops(ctx["config"]) / 2.0 / 1e12
    assert harness.reader("dsyn.mfu").read(ctx) == pytest.approx(want)
