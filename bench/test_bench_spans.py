"""The program-span metrics of ``bench/spans.py``: the device time of a
program span read from a synthetic trace, each metric on a synthetic
``ctx`` and None without its spans, ``flash_attention``'s span attributes
against the harness's ``call_shape`` of the same call, and a traced run of
each cell on the CPU at a tiny size with the program's tracer on."""
import time

import pytest
import torch

from bench import harness, spans, tracing
from bench.test_bench_faults import tiny
from bench.yardstick import attention

CPU = torch.device("cpu")
PEAKS = harness.load_json(harness.BENCH / "yardstick" / "peaks.json")


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_reads_a_program_span_s_device_time():
    """The MoE's stages as the profiler records them: host ranges nested
    in ``moe``, each device range over the launches of the innermost range
    (``moe`` itself has none)."""
    events = [
        X(tracing.WINDOW, "user_annotation", 0, 1000),
        X("gemm", "kernel", 100, 200), X("scan", "kernel", 400, 100),
        X("bmm", "kernel", 600, 300),
        X("moe", "user_annotation", 40, 920),
        X("moe.route", "user_annotation", 60, 200),
        X("moe.route", "gpu_user_annotation", 100, 150),
        X("moe.dispatch", "user_annotation", 270, 200),
        X("moe.dispatch", "gpu_user_annotation", 250, 250),
        X("moe.experts", "user_annotation", 500, 400),
        X("moe.experts", "gpu_user_annotation", 550, 400),
        X("moe.combine", "user_annotation", 910, 40),
        X("moe.combine", "gpu_user_annotation", 950, 10),
    ]
    s = tracing.summarize(events, list(spans.SPANS))
    assert s["region_s"]["moe.route"] == pytest.approx(150e-6)
    assert s["region_s"]["moe.dispatch"] == pytest.approx(150e-6)
    assert s["region_s"]["moe.experts"] == pytest.approx(300e-6)
    assert s["region_s"]["moe.combine"] == pytest.approx(0.0)
    assert s["region_s"]["serve.pad_caches"] is None
    ctx = {"trace": s}
    assert spans.moe_glue_device_share(ctx) == pytest.approx(50.0)
    assert spans.cache_pad_device_share(ctx) is None
    # each idle gap is named by the innermost span open at its midpoint
    assert s["idle_by_host"] == pytest.approx({"moe": 200e-6,
                                               "moe.dispatch": 100e-6,
                                               "moe.experts": 100e-6})


def _span(name, start, duration, **attrs):
    return {"name": name, "start": start, "duration": duration,
            "attrs": attrs}


CALL = dict(B=80, Sq=3137, Sk=3137, Hq=4, Hkv=4, hd=36, causal=False,
            dtype="float32", itemsize=4)


def _ctx(program, region_s=None, busy=2.0):
    return {"program": program, "peaks": PEAKS,
            "trace": {"busy_s": busy, "window_s": 2.1,
                      "region_s": region_s or {}}}


def test_each_metric_reads_its_spans_and_none_without_them():
    least = attention.least_seconds(CALL, PEAKS)
    program = [
        _span("wave.admit", 0.0, 0.002, wave=3),
        _span("wave.pack", 0.002, 0.001, wave=3),
        _span("flash_attention", 0.01, 0.001, **CALL),
        _span("flash_attention", 0.02, 0.001, **CALL),
        _span("wave.device", 5.0, 0.0, wave=2, device_ms=5300.0,
              gap_ms=0.25),
        _span("wave.admit", 5.4, 0.004, wave=4),
        _span("wave.pack", 5.404, 0.001, wave=4),
        _span("wave.device", 10.0, 0.0, wave=3, device_ms=5300.0,
              gap_ms=0.75),
        _span("wave.device", 10.1, 0.0, wave=0, device_ms=5300.0),
        _span("moe.dispatch", 11.0, 0.001, pairs=262144,
              expert_rows=1048576, dropped=0),
        _span("moe.dispatch", 11.1, 0.001, pairs=262144,
              expert_rows=1048576, dropped=1024),
    ]
    ctx = _ctx(program, {"flash_attention": 4 * least, "moe.route": 0.1,
                         "moe.dispatch": 0.3, "moe.experts": 1.0,
                         "moe.combine": 0.1, "serve.pad_caches": 0.02})
    assert spans.wave_gap_ms(ctx) == pytest.approx(0.5)
    assert spans.boundary_host_ms(ctx) == pytest.approx(4.0)
    assert spans.attention_span_roofline(ctx) == pytest.approx(50.0)
    assert spans.moe_glue_device_share(ctx) == pytest.approx(25.0)
    assert spans.moe_padded_row_share(ctx) == pytest.approx(
        100 * (1 - (2 * 262144 - 1024) / (2 * 1048576)))
    assert spans.cache_pad_device_share(ctx) == pytest.approx(1.0)
    empty = _ctx([], {})
    for name, (read, _) in spans.METRICS.items():
        assert read(empty) is None, name
        assert read({**empty, "trace": None}) is None, name


@pytest.mark.parametrize("kw", [{}, {"causal": False}])
def test_flash_attention_s_span_holds_the_harness_s_call_shape(kw):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.obs.trace import Tracer, using
    q = torch.randn(2, 5, 4, 8)
    k = v = torch.randn(2, 7, 2, 8)
    tr = Tracer()
    with using(tr):
        ops.flash_attention(q, k, v, **kw)
    (s,) = tr.spans
    recorded = ([tracing._arg(a) for a in (q, k, v)],
                {n: tracing._arg(x) for n, x in kw.items()})
    assert s.name == "flash_attention"
    assert s.attrs == attention.call_shape(*recorded)


@pytest.mark.parametrize("workload", ["dit224-uniform",
                                      "olmoe-prefill-docs"])
def test_a_traced_cpu_run_reads_the_window_s_program_spans(
        workload, monkeypatch):
    """A traced run at a tiny size on the CPU: the program's tracer is on
    only inside it, its spans of the window are read, and no module the
    benchmark forbids is loaded by it (the JAX package may be in this
    worker from other test files, so it is looked for among the modules
    the run adds)."""
    import sys

    from repro_torch.obs.trace import default
    before, forbidden = set(sys.modules), harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda names=None: [])
    got = {}
    program_spans = spans.program_spans

    def keep(tracer, window):
        got["window"] = (window.start, window.stop)
        got["spans"] = program_spans(tracer, window)
        return got["spans"]

    monkeypatch.setattr(spans, "program_spans", keep)
    res = spans.drive(tiny(workload), 2 ** 31 + 5, 0.3, CPU,
                      time.perf_counter())
    assert default().enabled is False
    lo, hi = got["window"]
    assert got["spans"] and all(lo <= s["start"] < hi for s in got["spans"])
    assert res["program_spans"] == len(got["spans"])
    names = {s["name"] for s in got["spans"]}
    if workload == "dit224-uniform":
        assert {"wave.admit", "wave.pack", "flash_attention"} <= names
        assert res["spans"]["dsyn.boundary_host_ms"] > 0
    else:
        assert {"serve.wave", "serve.pad_caches", "moe.dispatch",
                "flash_attention"} <= names
        share = res["spans"]["prefill.moe_padded_row_share"]
        assert 0 <= share < 100
    assert set(res["spans"]) <= set(spans.METRICS)
    assert forbidden(set(sys.modules) - before) == []
