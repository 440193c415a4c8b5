"""The frozen plain references against the program's plain route at tiny
sizes on the CPU.  The tests may import the program; the references may
not (``test_bench_imports.py``)."""
import numpy as np
import pytest
import torch

from bench import weights
from bench.drivers.prefill_batches import fp8
from bench.references import dit as ref_dit
from bench.references import moe_lm, threefry
from repro_torch import prng

CPU = torch.device("cpu")
KEYS = [np.array([0, 7], np.uint32), np.array([2 ** 32 - 1, 12345],
                                               np.uint32)]
DIT = {"d_model": 32, "num_layers": 2, "num_heads": 2, "patch": 4,
       "cond_dim": 512, "image_size": 16, "channels": 3,
       "train_timesteps": 1000}


@pytest.mark.parametrize("key", KEYS)
def test_threefry_copy_draws_what_the_program_draws(key):
    assert np.array_equal(threefry.fold_in(key, 5), prng.fold_in(key, 5))
    assert np.array_equal(threefry.split(key, 3), prng.split(key, 3))
    a = prng.normal(key, (3, 8, 8, 3))
    b = threefry.normal(key, (3, 8, 8, 3), CPU)
    assert torch.equal(a, b)
    # rows 1.. of a wave's draw, drawn alone from their offset
    c = threefry.normal(key, (2, 8, 8, 3), CPU, offset=8 * 8 * 3)
    assert torch.equal(a[1:], c)


def test_schedule_and_trajectory_match_the_program():
    from repro_torch.diffusion.guidance import respaced_ts
    from repro_torch.diffusion.schedule import make_schedule
    ab = make_schedule(1000, "cosine", device="cpu").alpha_bar.numpy()
    assert np.abs(ref_dit.alpha_bar(1000) - ab).max() < 1e-6
    for n in (1, 2, 4, 16, 17, 19, 27, 50, 100):
        assert np.array_equal(ref_dit.respaced(1000, n),
                              respaced_ts(1000, n).numpy())


def _dit(seed):
    from repro_torch.configs.oscar import DiffusionConfig
    from repro_torch.diffusion.dit import DiT
    dc = DiffusionConfig(d_model=32, num_layers=2, num_heads=2, patch=4,
                         cond_dim=512)
    m = DiT(dc, 16, 3, device="cpu")
    weights.fill_module(m, ref_dit.weight_groups(DIT), seed)
    w = weights.draw_group(ref_dit.weight_groups(DIT)[0], seed, 0, CPU)
    return m, w


def test_denoiser_matches_the_program_plain_route():
    m, w = _dit(3)
    m.plain = True
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 16, 3, generator=g)
    y = torch.randn(3, 512, generator=g)
    t = torch.tensor([0, 500, 999])
    with torch.no_grad():
        want = m(x, t, y)
    got = ref_dit.denoiser(w, DIT, x, t, y)
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


def test_sampled_rows_match_the_program_sampler():
    from repro_torch.diffusion.sampler import sample_cfg
    from repro_torch.diffusion.schedule import make_schedule
    m, w = _dit(4)
    sched = make_schedule(1000, "cosine", device="cpu")
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((4, 512)).astype(np.float32)
    key = KEYS[1]
    want = sample_cfg(m, sched, enc, key, image_size=16, num_steps=4,
                      guidance=2.0)
    got = ref_dit.sample_rows(w, DIT, key, 2, enc[2:], 2.0, 4, CPU)
    # float32 rounding, grown by the first step's division by √ᾱ_999
    assert (got - want[2:]).abs().max() < 5e-3
    assert (got - want[2:]).pow(2).mean().sqrt() < 2e-4


LM = {"name": "tiny-moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
      "num_kv_heads": 2, "head_dim": 16, "vocab_size": 300,
      "padded_vocab": 512, "qk_norm": True, "num_experts": 8, "top_k": 2,
      "d_ff_expert": 32, "rope_theta": 10000.0, "norm_eps": 1e-6,
      "dtype": "float32", "reference": "moe_lm"}


def test_moe_lm_matches_the_program_plain_route():
    from bench.drivers.prefill_batches import Driver
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import LM as ProgramLM
    mc = Driver(LM, {}, 0, CPU)._model_config()
    lm = ProgramLM(mc, device="cpu")
    groups = moe_lm.weight_groups(LM)
    weights.fill_module(lm, groups, 9)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 300, n).astype(np.int32) for n in (5, 12)]
    with torch.no_grad():
        want = [lm(torch.as_tensor(p)[None].long(),
                   Parallel(use_kernels=False))[0][0, -1, :300]
                for p in prompts]
    got = moe_lm.last_logits(
        LM, lambda g: weights.draw_group(groups[g], 9, g, CPU), prompts)
    for g, w in zip(got, want):
        assert (g - w).abs().max() < 1e-4 * w.abs().max()


def test_fp8_rounds_to_a_coarser_grid():
    t = torch.linspace(-3, 3, 1001)
    q = fp8(t)
    assert q.unique().numel() < 300
    assert (q - t).abs().max() < 0.1 * t.abs().max()


def test_weight_groups_are_deterministic_and_named():
    g = ref_dit.weight_groups(DIT)[0]
    a = weights.draw_group(g, 5, 0, CPU)
    b = weights.draw_group(g, 5, 0, CPU)
    c = weights.draw_group(g, 6, 0, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos"], c["pos"])
    m, _ = _dit(5)
    assert torch.equal(m.state_dict()["pos"], a["pos"])
    broken = [{"dtype": "float32", "tensors": g["tensors"][1:]}]
    with pytest.raises(ValueError):
        weights.fill_module(m, broken, 5)
