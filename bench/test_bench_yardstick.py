"""The yardstick's operation and byte counts against small shapes worked
out by hand, and the roofline and MFU readers on synthetic windows."""
from types import SimpleNamespace

import pytest

from bench import harness
from bench import tracing
from bench.yardstick import attention, dit, lm

PEAKS = harness.load_json(harness.BENCH / "yardstick" / "peaks.json")


@pytest.mark.parametrize("Sq,Sk,causal,want", [
    (4, 4, True, 10),          # 1 + 2 + 3 + 4
    (2, 4, True, 7),           # query 0 sees keys 0..2, query 1 all 4
    (4, 4, False, 16),
    (1, 5, True, 5),           # a decode-like query sees every key
])
def test_attention_pairs(Sq, Sk, causal, want):
    assert attention.pairs(Sq, Sk, causal) == want


def test_attention_flops_and_bytes_by_hand():
    # 4 · B · Hq · hd · pairs = 4 · 1 · 2 · 8 · 10
    assert attention.flops(1, 4, 4, 2, 8, True) == 640
    # itemsize · (q and o: 2 · 4 · 2 · 8, k and v: 2 · 4 · 1 · 8) = 4 · 192
    assert attention.bytes_moved(1, 4, 4, 2, 1, 8, 4) == 768


def test_least_seconds_takes_the_larger_bound():
    big = {"B": 64, "Sq": 3137, "Sk": 3137, "Hq": 4, "Hkv": 4, "hd": 36,
           "causal": False, "dtype": "float32", "itemsize": 4}
    f = attention.flops(64, 3137, 3137, 4, 36, False)
    assert attention.least_seconds(big, PEAKS) == pytest.approx(f / 67e12)
    tiny = dict(big, Sq=1, Sk=1, B=1)
    b = attention.bytes_moved(1, 1, 1, 4, 4, 36, 4)
    assert attention.least_seconds(tiny, PEAKS) == pytest.approx(b / 3.35e12)


def test_dit_row_call_flops_by_hand():
    cfg = {"d_model": 4, "patch": 2, "channels": 1, "image_size": 4,
           "cond_dim": 2, "num_layers": 1}
    # patch_in 128, t_mlp 64, y_proj + cond_tok 32, one block 2512
    # (modulation 192, qkv 480, attention 400, wo 160, MLP 1280),
    # out_mod 64, patch_out 128
    assert dit.row_call_flops(cfg) == 2928


def test_dit_row_call_flops_at_the_cell():
    cfg = harness.load_json(harness.BENCH / "configs" / "oscar-dit-224.json")
    # 4 blocks of 5.67 GFLOP attention and 1.56 GFLOP products
    assert 28.5e9 < dit.row_call_flops(cfg) < 29.5e9


def test_lm_prefill_flops_by_hand():
    cfg = {"d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
           "num_experts": 4, "top_k": 2, "d_ff_expert": 3, "vocab_size": 10,
           "num_layers": 1}
    # 2 · 3 tokens · (projections 48 + router 16 + experts 72) = 816,
    # causal attention 4 · 2 heads · 2 · 6 pairs = 96, head 2 · 4 · 10
    assert lm.prefill_flops(cfg, 3) == 992


def test_lm_prefill_flops_at_the_cell():
    cfg = harness.load_json(harness.BENCH / "configs" / "olmoe-1b-7b.json")
    per_token = lm.prefill_flops(cfg, 2048) / 2048
    assert 2.2e9 < per_token < 2.5e9


def _ctx(calls, region_s, busy=1.0, window=2.0):
    w = SimpleNamespace(start=0.0, stop=10.0)
    return {"trace": {"region_s": {"attention": region_s}, "busy_s": busy,
                      "window_s": window},
            "calls": {"attention": calls}, "window": w, "peaks": PEAKS}


def test_roofline_share_reads_recorded_calls_in_the_window():
    q = {"shape": (2, 64, 4, 32), "dtype": "bfloat16", "itemsize": 2}
    k = {"shape": (2, 64, 2, 32), "dtype": "bfloat16", "itemsize": 2}
    call = (1.0, [q, k, k], {"causal": True})
    late = (11.0, [q, k, k], {"causal": True})     # after the window
    shape = attention.call_shape([q, k, k], {"causal": True})
    assert shape == {"B": 2, "Sq": 64, "Sk": 64, "Hq": 4, "Hkv": 2,
                     "hd": 32, "causal": True, "dtype": "bfloat16",
                     "itemsize": 2}
    least = attention.least_seconds(shape, PEAKS)
    got = attention.roofline_share(_ctx([call, call, late], 4 * least))
    assert got == pytest.approx(50.0)
    assert attention.roofline_share(_ctx([], 1.0)) is None
    assert attention.roofline_share(_ctx([call], None)) is None


def test_idle_share():
    assert tracing.idle_share(_ctx([], 1.0, busy=1.5, window=2.0)) == \
        pytest.approx(25.0)
    assert tracing.idle_share({"trace": None}) is None
