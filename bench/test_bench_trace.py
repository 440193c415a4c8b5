"""The reduction of a profiler trace to the window's numbers, on a
synthetic trace whose busy, region and idle times are known."""
import pytest

from bench import tracing


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    X(tracing.WINDOW, "user_annotation", 100, 1000),
    # device work: [50, 150) clipped to [100, 150), [140, 300) overlapping,
    # [500, 600), [1050, 1200) clipped to [1050, 1100)
    X("gemm", "kernel", 50, 100), X("attn_fwd", "kernel", 140, 160),
    X("copy", "gpu_memcpy", 500, 100), X("gemm", "kernel", 1050, 150),
    X("attention", "gpu_user_annotation", 130, 200),
    # host: a long op over the first gap, a short one inside it
    X("aten::cat", "cpu_op", 290, 300), X("aten::item", "cpu_op", 350, 100),
    X("poll", "user_annotation", 600, 500),
]


def test_busy_regions_and_kernels():
    s = tracing.summarize(EVENTS, ["attention", "moe"])
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((200 + 100 + 50) * 1e-6)
    assert s["kernels"] == 4
    assert s["by_kernel"]["gemm"] == pytest.approx(100e-6)
    assert s["by_kernel"]["attn_fwd"] == pytest.approx(160e-6)
    # the region [130, 330) holds [130, 150) of the first gemm and all of
    # attn_fwd
    assert s["region_s"]["attention"] == pytest.approx(180e-6)
    assert s["region_s"]["moe"] is None


def test_idle_gaps_are_named_by_the_innermost_host_event():
    s = tracing.summarize(EVENTS)
    idle = s["idle_by_host"]
    # gaps [300, 500) (mid 400: aten::item inside aten::cat) and
    # [600, 1050) (mid 825: poll)
    assert idle == pytest.approx({"aten::item": 200e-6, "poll": 450e-6})
    assert sum(idle.values()) == pytest.approx(
        s["window_s"] - s["busy_s"])


def test_no_window_no_summary():
    assert tracing.summarize(EVENTS[1:]) is None


def test_breakdown_keeps_ten_of_each():
    s = {"by_kernel": {f"k{i}": float(i) for i in range(15)},
         "idle_by_host": {"a": 1.0}}
    b = tracing.breakdown(s)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k14", 14.0]
    assert b["idle_gaps"] == [["a", 1.0]]
