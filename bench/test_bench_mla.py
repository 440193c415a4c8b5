"""The DeepSeek-V3 block's yardsticks (``yardstick/mla.py``,
``yardstick/mla_lm.py``) against small shapes worked out by hand, and its
configuration against the program's: the JSON builds the registered
config, and the reference's weight groups name the full-size LM's
parameters with their shapes."""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.drivers.prefill_batches_mla import Driver
from bench.references import mla_moe_lm
from bench.yardstick import attention, mla, mla_lm

PEAKS = harness.load_json(harness.BENCH / "yardstick" / "peaks.json")
MOONLIGHT = harness.load_json(harness.BENCH / "configs" /
                              "moonlight-16b-a3b.json")


def test_mla_flops_and_bytes_by_hand():
    # 2 · B · Hq · (dqk + dv) · pairs = 2 · 1 · 2 · (6 + 4) · 10
    assert mla.flops(1, 4, 4, 2, 6, 4, True) == 400
    # itemsize · (q and o: 4 · 2 · (6 + 4), k and v: 4 · 1 · (6 + 4))
    assert mla.bytes_moved(1, 4, 4, 2, 1, 6, 4, 2) == 2 * 120


def test_mla_roofline_counts_p_v_at_the_configuration_dv():
    """A call whose v was padded to q's head dim is credited at the
    configuration's dv, not the padded width."""
    q = {"shape": (2, 256, 16, 192), "dtype": "bfloat16", "itemsize": 2}
    v = {"shape": (2, 256, 16, 192), "dtype": "bfloat16", "itemsize": 2}
    call = (1.0, [q, q, v], {"causal": True})
    late = (11.0, [q, q, v], {"causal": True})
    shape = attention.call_shape([q, q, v], {"causal": True})
    least = mla.least_seconds(shape, 128, PEAKS)
    f = mla.flops(2, 256, 256, 16, 192, 128, True)
    b = mla.bytes_moved(2, 256, 256, 16, 16, 192, 128, 2)
    assert least == pytest.approx(max(f / 989e12, b / 3.35e12))
    ctx = {"trace": {"region_s": {"attention": 4 * least}, "busy_s": 1.0},
           "calls": {"attention": [call, late]},
           "window": SimpleNamespace(start=0.0, stop=10.0), "peaks": PEAKS,
           "config": {"v_head_dim": 128}}
    assert mla.roofline_share(ctx) == pytest.approx(25.0)
    assert mla.roofline_share(dict(ctx, calls={})) is None


def test_mla_lm_prefill_flops_by_hand():
    cfg = {"hidden_size": 4, "num_attention_heads": 2, "qk_nope_head_dim": 2,
           "qk_rope_head_dim": 1, "v_head_dim": 2, "kv_lora_rank": 3,
           "moe_intermediate_size": 2, "n_routed_experts": 4,
           "num_experts_per_tok": 2, "n_shared_experts": 1,
           "intermediate_size": 5, "num_hidden_layers": 2,
           "first_k_dense_replace": 1, "vocab_size": 10}
    # projections: q 4·6 + kv-down 4·4 + kv-up 3·8 + o 4·4 = 80;
    # dense FFN 3·4·5 = 60; MoE router 16 + 3 experts · 24 = 88;
    # attention 2 · 2 heads · (3 + 2) · 6 pairs = 120 a layer;
    # 2 · 3 tokens · (80 + 60) + 120 + 2 · 3 · (80 + 88) + 120 + head 80
    assert mla_lm.prefill_flops(cfg, 3) == 840 + 120 + 1008 + 120 + 80


def test_mla_lm_prefill_flops_at_the_cell():
    """About twice the 2.91 B active parameters a token less the
    embedding, plus attention at 8192 positions."""
    per_token = mla_lm.prefill_flops(MOONLIGHT, 8192) / 8192
    assert 5.0e9 < per_token < 6.0e9


def test_the_json_builds_the_registered_config():
    from repro_torch.configs import get_config
    mc = Driver(MOONLIGHT, {}, 0, torch.device("cpu"))._model_config()
    reg = get_config("moonlight-16b-a3b")
    assert dataclasses.replace(mc, source=reg.source, remat=reg.remat) == reg
    assert mc.param_counts()["total"] == 15_959_982_080


def test_weight_groups_name_the_full_size_lm():
    from repro_torch.models.transformer import LM
    mc = Driver(MOONLIGHT, {}, 0, torch.device("cpu"))._model_config()
    lm = LM(mc, device="meta")
    want = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    got = {n: shape for g in mla_moe_lm.weight_groups(
        dict(MOONLIGHT, num_layers=27)) for n, shape, _ in g["tensors"]}
    assert got == want
    assert len(mla_moe_lm.weight_groups(MOONLIGHT)) == 3 + 27


def tiny() -> harness.Cell:
    """The moonlight cell at a CPU size, with its real limits."""
    cell = harness.find_cell("moonlight-prefill-docs")
    cell.config = dict(
        cell.config, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
        num_experts_per_tok=2, vocab_size=300, padded_vocab=512,
        dtype="float32")
    cell.traffic = dict(cell.traffic, batch=[[8, 3], [16, 2], [24, 1]],
                        max_len=25, check_batches=2)
    return cell


@pytest.fixture
def no_jax_check(monkeypatch):
    """Other test files load the JAX package into this worker; the import
    check itself is tested in ``test_bench_imports.py``."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda names=None: [])


def test_a_traced_cpu_run_of_the_cell_is_correct_and_reads_its_metrics(
        no_jax_check):
    import time
    cell = tiny()
    res = harness.drive(cell, 2 ** 31 + 5, 0.3, True, torch.device("cpu"),
                        time.perf_counter())
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    m = res["metrics"]
    assert m["prefill.tokens_per_wave"]["value"] > 0
    assert 0 < m["prefill_mla.mfu"]["value"]
    # no card: the profiler sees no device work, so the device shares are
    # absent rather than 0
    assert "prefill_mla.latent_device_share" not in m


@pytest.mark.parametrize("fault", ["layer_returns_its_input",
                                   "half_of_each_wave_skipped",
                                   "logits_altered"])
def test_a_fault_in_the_cell_is_caught(no_jax_check, fault):
    import time
    from bench.test_bench_faults import PREFILL_FAULTS
    with PREFILL_FAULTS[fault]():
        res = harness.drive(tiny(), 2 ** 31 + 5, 0.3, False,
                            torch.device("cpu"), time.perf_counter())
    assert not res["correct"], res["check"]


def test_the_reference_imports_nothing_of_the_program():
    import os
    import subprocess
    import sys
    code = ("import sys, bench.references.mla_moe_lm\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'repro', 'repro_torch', 'jax', 'jaxlib',"
            " 'flax'}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
