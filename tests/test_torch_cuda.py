"""The port's hand-written kernels against their plain PyTorch versions on
a CUDA card, and the kernel paths of the sampler and of the LM serving
engine against their plain paths.

Every test here is marked ``cuda`` and skips (deciding inside the test)
where there is no card.  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.diffusion.dit import init_dit
from repro_torch.diffusion.sampler import (sample_cfg, sample_cfg_ragged,
                                           sample_classifier_guided,
                                           sample_mixed)
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels.adaln_norm import ops as an_ops
from repro_torch.kernels.adaln_norm import ref as an_ref
from repro_torch.kernels.cfg_fuse import kernel as cfg_kernel
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref
from repro_torch.kernels.adaln_norm import kernel as an_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.models import attention as lm_attention
from repro_torch.models.classifiers import classifier_logprob, init_classifier
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils import recorded_relu

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.utils import default_device
    return default_device()


def _randn(dev, seed, *shapes):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev) for s in shapes]


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("shape", [(128, 16, 16, 3), (3, 5, 7)])
def test_cfg_update_kernel_matches_plain(dev, shape):
    x, ec, eu, z = _randn(dev, 0, shape, shape, shape, shape)
    before = cfg_ops.cfg_update.launches
    for ab_t, ab_prev in [(2.4288882e-09, 0.24600048), (0.3, 0.6)]:
        out = cfg_ops.cfg_update(x, ec, eu, 2.0, ab_t, ab_prev, z)
        ref = cfg_ref.cfg_update(x, ec, eu, 2.0, ab_t, ab_prev, z)
        assert _err(out, ref) <= 1e-6
    assert cfg_ops.cfg_update.launches == before + 2


def _rowwise_table(Bs):
    """(s, ᾱ_t, ᾱ_prev, active) rows: a t = 999 first step of a 4-step
    trajectory, a mid step, a last step and an inactive row, in turn."""
    table = [(2.0, 2.4288882e-09, 0.24600048, 1), (7.5, 0.3, 0.6, 1),
             (1.5, 0.9, 1.0, 1), (4.0, 0.05, 0.2, 0)]
    rows = [table[i % 4] for i in range(Bs)]
    return [np.array(c, np.float32) for c in zip(*rows)]


@pytest.mark.parametrize("B,Bs,off", [(120, 120, 0), (60, 120, 0),
                                      (60, 120, 60), (5, 9, 3)])
def test_cfg_update_rowwise_kernel_is_bit_equal_to_plain(dev, B, Bs, off):
    s, ab_t, ab_prev, act = _rowwise_table(Bs)
    x, ec, eu, z = _randn(dev, 5, *[(B, 16, 16, 3)] * 4)
    before = cfg_ops.cfg_update_rowwise.launches
    out = cfg_ops.cfg_update_rowwise(x, ec, eu, s, ab_t, ab_prev, z, act,
                                     row_offset=off)
    assert cfg_ops.cfg_update_rowwise.launches == before + 1
    dev_vecs = [torch.as_tensor(v, device=dev) for v in (s, ab_t, ab_prev,
                                                         act)]
    ref = cfg_ref.cfg_update_rowwise_windowed(
        x, ec, eu, *dev_vecs[:3], z, dev_vecs[3], row_offset=off)
    assert torch.equal(out, ref)
    frozen = act[off:off + B] == 0
    assert torch.equal(out[torch.as_tensor(frozen, device=dev)],
                       x[torch.as_tensor(frozen, device=dev)])
    for bad in (-1, Bs - B + 1):
        with pytest.raises(ValueError):
            cfg_ops.cfg_update_rowwise(x, ec, eu, s, ab_t, ab_prev, z, act,
                                       row_offset=bad)


@pytest.mark.parametrize("B,Bs,off", [(120, 120, 0), (60, 120, 60),
                                      (5, 9, 3)])
@pytest.mark.parametrize("keyed", [False, True])
def test_cfg_update_mixed_kernel_is_bit_equal_to_plain(dev, B, Bs, off,
                                                       keyed):
    """All classifier-free, all classifier-guided and mixed rows, against
    the plain version at error 0, with z from memory or drawn from each
    row's key (the plain version then fed ``prng.normal`` of the row keys
    times live); the all-mode-0 call is also bit-equal to the rowwise
    kernel in the same noise mode."""
    s, ab_t, ab_prev, act = _rowwise_table(Bs)
    x, ec, eu, z = _randn(dev, 7, *[(B, 16, 16, 3)] * 4)
    zk = {}
    if keyed:
        keys = prng.split(prng.PRNGKey(8), B)
        live = torch.as_tensor(np.arange(B) % 5 != 2, device=dev).float()
        zk = dict(noise_keys=cfg_ops.key_table(keys, dev), live=live)
        z_in, z = None, cfg_ref.row_noise(keys, live, (16, 16, 3), dev)
    else:
        z_in = z
    dev_vecs = [torch.as_tensor(v, device=dev) for v in (s, ab_t, ab_prev,
                                                         act)]
    frozen = torch.as_tensor(act[off:off + B] == 0, device=dev)
    i = np.arange(Bs)
    fn = cfg_ops.cfg_update_mixed
    for mode in (0 * i, 0 * i + 1, (i % 3 == 1) * 1):
        mode = mode.astype(np.float32)
        before = (fn.launches, fn.launches_keyed)
        out = fn(x, ec, eu, mode, s, ab_t, ab_prev, z_in, act,
                 row_offset=off, **zk)
        assert (fn.launches - before[0], fn.launches_keyed - before[1]) \
            == (1, int(keyed))
        ref = cfg_ref.cfg_update_mixed_windowed(
            x, ec, eu, torch.as_tensor(mode, device=dev), *dev_vecs[:3], z,
            dev_vecs[3], row_offset=off)
        assert torch.equal(out, ref)
        assert torch.equal(out[frozen], x[frozen])
    out = fn(x, ec, eu, 0 * s, s, ab_t, ab_prev, z_in, act, row_offset=off,
             **zk)
    assert torch.equal(out, cfg_ops.cfg_update_rowwise(
        x, ec, eu, s, ab_t, ab_prev, z_in, act, row_offset=off, **zk))
    for bad in (-1, Bs - B + 1):
        with pytest.raises(ValueError):
            fn(x, ec, eu, 0 * s, s, ab_t, ab_prev, z_in, act,
               row_offset=bad, **zk)


# (ᾱ_t, ᾱ_prev, t): the t = 999 first step of a 4-step trajectory, a mid
# step and the last (t = 0) step
CFG_STEPS = [(2.4288882e-09, 0.24600048, 999), (0.3, 0.6, 500),
             (0.9, 1.0, 0)]


def _offset_view(dev, seed, shape):
    """A contiguous tensor 4 bytes off 16-byte alignment: the kernel reads
    it one element at a time."""
    n = int(np.prod(shape))
    (buf,) = _randn(dev, seed, (n + 1,))
    return buf[1:].view(shape)


@pytest.mark.parametrize("shape,layout", [
    ((128, 16, 16, 3), "contiguous"), ((120, 16, 16, 3), "contiguous"),
    ((3, 5, 7), "contiguous"), ((120, 16, 16, 3), "offset")])
@pytest.mark.parametrize("keyed", [False, True])
def test_cfg_update_kernel_modes_are_bit_equal_to_plain(dev, shape, layout,
                                                        keyed):
    """Both noise sources at the first, a mid and the last step: z from
    memory against ``ref.cfg_update``, z drawn from the step key against
    ``prng.normal`` of that key then ``ref.cfg_update`` (zero at t = 0)."""
    if layout == "offset":
        x, ec, eu, z = (_offset_view(dev, 20 + i, shape) for i in range(4))
    else:
        x, ec, eu, z = _randn(dev, 20, shape, shape, shape, shape)
    key = prng.split(prng.PRNGKey(6))[1]
    for ab_t, ab_prev, t in CFG_STEPS:
        n0 = (cfg_ops.cfg_update.launches, cfg_ops.cfg_update.launches_keyed)
        if keyed:
            out = cfg_ops.cfg_update(x, ec, eu, 2.0, ab_t, ab_prev, None,
                                     noise_key=tuple(int(k) for k in key),
                                     live=t > 0)
            zz = (prng.normal(key, shape, dev) if t > 0
                  else torch.zeros_like(x))
        else:
            out, zz = cfg_ops.cfg_update(x, ec, eu, 2.0, ab_t, ab_prev, z), z
        assert (cfg_ops.cfg_update.launches - n0[0],
                cfg_ops.cfg_update.launches_keyed - n0[1]) == (1, int(keyed))
        assert torch.equal(out, cfg_ref.cfg_update(x, ec, eu, 2.0, ab_t,
                                                   ab_prev, zz))


@pytest.mark.parametrize("B,Bs,off,row", [
    (120, 120, 0, (16, 16, 3)), (128, 128, 0, (16, 16, 3)),
    (120, 240, 120, (16, 16, 3)), (60, 240, 37, (16, 16, 3)),
    (3, 9, 0, (5, 7)), (5, 9, 3, (5, 7))])
@pytest.mark.parametrize("keyed", [False, True])
def test_cfg_update_rowwise_kernel_modes_are_bit_equal_to_plain(
        dev, B, Bs, off, row, keyed):
    """Both noise sources over windows of a wider table, with frozen rows,
    rows at the t = 999 first step and rows at their t = 0 last step:
    against the plain version fed z, or ``prng.normal`` of each row's key
    times its live entry."""
    s, ab_t, ab_prev, act = _rowwise_table(Bs)
    x, ec, eu, z = _randn(dev, 21, *[(B, *row)] * 4)
    keys = prng.split(prng.PRNGKey(7), B)
    live = torch.as_tensor(np.arange(B) % 5 != 2, device=dev).float()
    n0 = (cfg_ops.cfg_update_rowwise.launches,
          cfg_ops.cfg_update_rowwise.launches_keyed)
    if keyed:
        out = cfg_ops.cfg_update_rowwise(
            x, ec, eu, s, ab_t, ab_prev, None, act, row_offset=off,
            noise_keys=cfg_ops.key_table(keys, dev), live=live)
        z = prng.normal(keys, row, dev) * live.reshape(-1, *[1] * len(row))
    else:
        out = cfg_ops.cfg_update_rowwise(x, ec, eu, s, ab_t, ab_prev, z, act,
                                         row_offset=off)
    assert (cfg_ops.cfg_update_rowwise.launches - n0[0],
            cfg_ops.cfg_update_rowwise.launches_keyed - n0[1]) \
        == (1, int(keyed))
    dev_vecs = [torch.as_tensor(v, device=dev) for v in (s, ab_t, ab_prev,
                                                         act)]
    ref = cfg_ref.cfg_update_rowwise_windowed(
        x, ec, eu, *dev_vecs[:3], z, dev_vecs[3], row_offset=off)
    assert torch.equal(out, ref)
    frozen = torch.as_tensor(act[off:off + B] == 0, device=dev)
    assert torch.equal(out[frozen], x[frozen])


def test_cfg_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev, dtype=torch.bfloat16)
    vec = np.ones(4, np.float32)
    with pytest.raises(NotImplementedError):
        cfg_ops.cfg_update(x, x, x, 1.0, 0.3, 0.6, x)
    with pytest.raises(NotImplementedError):
        cfg_ops.cfg_update_mixed(x, x, x, vec, vec, vec, vec, x, vec)
    x = torch.zeros(4, 8, device=dev)
    keys = cfg_ops.key_table(prng.split(prng.PRNGKey(0), 4), dev)
    with pytest.raises(ValueError):          # keys of the wrong rows
        cfg_ops.cfg_update_rowwise(x, x, x, vec, vec, vec, None, vec,
                                   noise_keys=keys[:3],
                                   live=torch.ones(3, device=dev))
    with pytest.raises(ValueError):          # keys off the card
        cfg_ops.cfg_update_rowwise(x, x, x, vec, vec, vec, None, vec,
                                   noise_keys=keys.cpu(),
                                   live=torch.ones(4, device=dev))
    with pytest.raises(ValueError):          # keys off the card, mixed
        cfg_ops.cfg_update_mixed(x, x, x, vec, vec, vec, vec, None, vec,
                                 noise_keys=keys.cpu(),
                                 live=torch.ones(4, device=dev))
    with pytest.raises(ValueError):          # the table off the card
        cfg_ops.cfg_update_mixed(
            x, x, x, vec, vec, vec, vec, x, vec,
            coeffs=torch.as_tensor(cfg_ops.mixed_coeffs(vec, vec, vec, vec,
                                                        vec, 1.0)))
    assert cfg_ops.cfg_update_mixed(x[:0], x[:0], x[:0], vec, vec, vec, vec,
                                    x[:0], vec).shape == (0, 8)


def test_cfg_library_refuses_a_mixed_launch_without_its_operands(dev):
    """The library's own check, below the wrappers: a mixed (variant 2)
    block without a table, or keyed without keys or live, is refused
    before any launch (cudaErrorInvalidValue); with them it launches."""
    B = 4
    x = torch.zeros(B, 8, device=dev)
    out = torch.empty_like(x)
    table = torch.as_tensor(cfg_ops.mixed_coeffs(np.ones(B), *[np.full(
        B, v, np.float32) for v in (2.0, 0.3, 0.6, 1.0)], 1.0), device=dev)
    keys = cfg_ops.key_table(prng.split(prng.PRNGKey(0), B), dev)
    live = torch.ones(B, device=dev)
    fields = list(cfg_kernel._ARGS.unpack(cfg_kernel._args(
        x, x, x, None, out, rows=B, coeffs=table, mixed=True, keys=keys,
        live=live)))
    assert fields[12:14] == [2, 1]           # variant 2, keyed
    lib = cfg_kernel._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for slot in (5, 6, 7):                   # no table, keys or live
        bad = list(fields)
        bad[slot] = 0
        assert lib.cfg_fuse_fwd(cfg_kernel._ARGS.pack(*bad), stream) != 0
    bad = list(fields)
    bad[12] = 3                              # no such variant
    assert lib.cfg_fuse_fwd(cfg_kernel._ARGS.pack(*bad), stream) != 0
    assert lib.cfg_fuse_fwd(cfg_kernel._ARGS.pack(*fields), stream) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("B,N,d", [(256, 17, 144), (256, 16, 144),
                                   (256, 17, 128), (64, 17, 145),
                                   (3, 40, 2048)])
def test_adaln_norm_kernel_matches_plain(dev, B, N, d):
    x, mod = _randn(dev, 1, (B, N + 1, d), (B, 6 * d))
    x, sc, sh = x[:, 1:], mod[:, d:2 * d], mod[:, :d]   # strided, as in the DiT
    assert _err(an_ops.adaln_norm(x, sc, sh), an_ref.adaln_norm(x, sc, sh)) \
        < 1e-5


ADALN_SITES = {"block": (256, 17, 144, 0), "final_view": (256, 16, 144, 1),
               "d128": (256, 17, 128, 0), "odd_d": (64, 17, 145, 0)}


def _adaln_inputs(dev, site, dtype):
    B, N, d, drop = ADALN_SITES[site]
    x, mod = _randn(dev, 2, (B, N + drop, d), (B, 6 * d))
    x, mod = x.to(dtype)[:, drop:], mod.to(dtype)
    return x, mod[:, d:2 * d], mod[:, :d]


@pytest.mark.parametrize("site", list(ADALN_SITES))
def test_adaln_norm_kernel_in_bf16(dev, site):
    """The DiT's block site, its final tok[:, 1:] view, d 128 and an odd d
    (read one element at a time) in bf16: within one bf16 ulp (2^-7 of the
    element) plus 1e-5 of the plain version in fp32 on the same bf16
    inputs.  The kernel rounds its fp32 result once; where the shift
    cancels the scaled term, the fp32 roundings of the two orders (the
    kernel fuses the multiply-add) are what is left."""
    x, sc, sh = _adaln_inputs(dev, site, torch.bfloat16)
    assert an_kernel.vector_route(x) == (site != "odd_d")
    before = an_ops.adaln_norm.launches
    out = an_ops.adaln_norm(x, sc, sh)
    assert an_ops.adaln_norm.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape and out.is_contiguous()
    ref = an_ref.adaln_norm(x.float(), sc.float(), sh.float())
    assert bool(((out.float() - ref).abs()
                 <= 2.0 ** -7 * ref.abs() + 1e-5).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaln_norm_kernel_is_bit_equal_to_itself(dev, dtype):
    xs = _adaln_inputs(dev, "block", getattr(torch, dtype))
    assert torch.equal(an_ops.adaln_norm(*xs), an_ops.adaln_norm(*xs))


@pytest.mark.parametrize("B,S,H,hd", [(256, 17, 4, 36), (256, 17, 4, 32),
                                      (4, 3137, 4, 32), (2, 40, 2, 128)])
def test_attention_kernel_matches_plain(dev, B, S, H, hd):
    (qkv,) = _randn(dev, 2, (B, S, 3, H, hd))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa_ops.flash_attention(q, k, v, causal=False)
    ref = fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=False).transpose(1, 2)
    assert _err(out, ref) < 2e-5


def test_attention_kernel_refuses_unported_modes(dev):
    """Every mode of the reference kernel runs on the card; what the
    kernel still does not take raises: fp16, head dim > 256, query heads
    not a multiple of kv heads, and a non-unit stride over hd."""
    q, k, v = _randn(dev, 3, (1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    with pytest.raises(NotImplementedError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    big = _randn(dev, 3, (1, 8, 2, 264))[0]
    with pytest.raises(ValueError):
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q[:, :, :3], k, v)
    (qkv,) = _randn(dev, 3, (1, 8, 4, 32))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qkv[..., ::2], k, v)


def _plain_attention(q, k, v, **kw):
    return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), **kw).transpose(1, 2)


ATTN_MODES = {"causal": dict(causal=True),
              "causal_window": dict(causal=True, window=40),
              "causal_window_softcap": dict(causal=True, window=40,
                                            softcap=50.0),
              "noncausal": dict(causal=False)}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 4), (8, 1)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_modes_match_plain(dev, mode, Hq, Hkv, hd, dtype):
    """The mode grid at a ragged S = 100, window 40:
    fp32 within 2e-5 and bf16 within 2e-2 (one bf16 ulp of the output), the
    reference's own gates.  bf16 takes the tensor-core kernel, fp32 the
    CUDA-core one."""
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _randn(dev, 11, (2, 100, Hq, hd),
                                        (2, 100, Hkv, hd), (2, 100, Hkv, hd)))
    kw = ATTN_MODES[mode]
    fa = fa_ops.flash_attention
    before = (fa.launches, fa.launches_tensor_core, fa.launches_cuda_core)
    out = fa_ops.flash_attention(q, k, v, **kw)
    tc = dtype == "bfloat16"
    assert (fa.launches, fa.launches_tensor_core, fa.launches_cuda_core) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    assert out.dtype == dt and out.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert _err(out.float(), _plain_attention(q, k, v, **kw).float()) < tol


def test_attention_kernel_at_gemma2_prefill_length(dev):
    """S = 4608 > the 4096 window, gemma2's local mode in bf16, one head."""
    q, k, v = (t.bfloat16() for t in _randn(dev, 12, (1, 4608, 2, 256),
                                            (1, 4608, 1, 256),
                                            (1, 4608, 1, 256)))
    kw = dict(causal=True, window=4096, softcap=50.0)
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert _err(out.float(), _plain_attention(q, k, v, **kw).float()) < 2e-2


def _bf16_gates(out, ref):
    """The bf16 gates: 2e-2 absolute, and each row within 2^-6 of its
    largest value (two bf16 ulps)."""
    d = (out.float() - ref.float()).abs()
    rel = d.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)
    return float(d.max()) <= 2e-2 and float(rel.max()) <= 2.0 ** -6


# (causal, window, softcap, q scale): q x 10 drives the scores to +-40, at
# the cap's knee when the cap is 50
TC_MODES = {"causal": (True, 0, 0.0, 1.0),
            "causal_window64": (True, 64, 0.0, 1.0),
            "causal_window65_cap": (True, 65, 50.0, 10.0),
            "causal_window4096_cap": (True, 4096, 50.0, 10.0),
            "causal_sharp": (True, 0, 0.0, 10.0),
            "noncausal": (False, 0, 0.0, 1.0),
            "noncausal_cap": (False, 0, 50.0, 10.0)}


def _tc_inputs(dev, seed, B, Sq, Sk, Hq, Hkv, hd, q_scale):
    q, k, v = _randn(dev, seed, (B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                     (B, Sk, Hkv, hd))
    # with scores at +-40 a row is nearly one-hot and its output is one v
    # entry; v at half scale keeps those under 4, where the 2e-2 absolute
    # gate is one bf16 ulp (above 4 an ulp is 0.031, and any two roundings
    # of one fp32 value may differ by it)
    v = v * (0.5 if q_scale > 1 else 1.0)
    return q.mul(q_scale).bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.parametrize("mode", list(TC_MODES))
@pytest.mark.parametrize("S", [1, 63, 64, 65, 100, 129, 4608])
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 8, 64), (8, 4, 128), (8, 1, 256),
                                       (8, 4, 256), (16, 16, 80),
                                       (14, 2, 64)])
def test_attention_tensor_core_kernel_grid(dev, mode, S, Hq, Hkv, hd):
    """The tensor-core kernel against the plain version at lengths of 1,
    one 64-key tile and one key either side of it, a ragged 100 and 129
    (one past the 128-row query tile) and gemma2's 4608; windows on (64)
    and off (65) a key-tile boundary and gemma2's 4096; GQA 8/8, 8/4 and
    8/1; head dims 64, 128 and 256; hubert-xlarge's 16/16 heads of 80 (the
    128-column class, TMA filling columns 80-127 with zeros and clipping
    them from the store) and internvl2-1b's GQA 14/2 of 64 (a kv head
    h / 7, not a power of two).  Length 1 at head dim 64 is the
    short-sequence kernel's call, within the same gates."""
    causal, window, softcap, q_scale = TC_MODES[mode]
    q, k, v = _tc_inputs(dev, 21, 1 if S > 1000 else 2, S, S, Hq, Hkv, hd,
                         q_scale)
    kw = dict(causal=causal, window=window, softcap=softcap)
    fa = fa_ops.flash_attention
    before = (fa.launches_tensor_core, fa.launches_short)
    out = fa_ops.flash_attention(q, k, v, **kw)
    short = S <= 32 and hd <= 64      # the short-sequence kernel's calls
    assert (fa.launches_tensor_core, fa.launches_short) == (
        before[0] + (not short), before[1] + short)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _bf16_gates(out, _plain_attention(q, k, v, **kw))


@pytest.mark.parametrize("Sq,Sk", [(100, 37), (37, 300), (1, 129),
                                   (65, 4608)])
@pytest.mark.parametrize("window,softcap,q_scale", [(0, 0.0, 1.0),
                                                    (0, 50.0, 10.0),
                                                    (64, 0.0, 1.0)])
def test_attention_tensor_core_kernel_with_more_keys_or_queries(
        dev, Sq, Sk, window, softcap, q_scale):
    """Non-causal attention with Sq != Sk (cross attention's shape)."""
    q, k, v = _tc_inputs(dev, 22, 2, Sq, Sk, 8, 4, 256, q_scale)
    kw = dict(causal=False, window=window, softcap=softcap)
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert _bf16_gates(out, _plain_attention(q, k, v, **kw))


@pytest.mark.parametrize("mode", ["causal", "causal_window65_cap",
                                  "causal_sharp", "noncausal"])
@pytest.mark.parametrize("S", [1, 65, 129, 4608])
@pytest.mark.parametrize("hd,hdv", [(192, 128)])
def test_attention_tensor_core_kernel_split_head_dims(dev, mode, S, hd,
                                                       hdv):
    """The tensor-core kernel's (192, 128) class against the plain version:
    q and k at 192 against v and o at 128 (latent attention's heads, 16 of
    them); V is read as it is, not padded, and o has v's head dim."""
    causal, window, softcap, q_scale = TC_MODES[mode]
    q, k, v = _tc_inputs(dev, 26, 1 if S > 1000 else 2, S, S, 16, 16, hd,
                         q_scale)
    v = v[..., :hdv].contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap)
    fa = fa_ops.flash_attention
    before = (fa.launches_tensor_core, fa.launches_cuda_core)
    out = fa(q, k, v, **kw)
    assert (fa.launches_tensor_core, fa.launches_cuda_core) == (
        before[0] + 1, before[1])
    assert out.shape == (*q.shape[:3], hdv) and out.is_contiguous()
    assert _bf16_gates(out, _plain_attention(q, k, v, **kw))


def test_split_head_dims_the_tensor_cores_do_not_take_raise(dev):
    """v's head dim below q's outside the (192, 128) class raises on the
    card, with nothing launched: fp32 at (192, 128), bf16 at (256, 128) and
    at (144, 80), and bf16 (192, 128) at strides TMA cannot address."""
    q, k, v = _randn(dev, 27, (2, 100, 4, 192), (2, 100, 4, 192),
                     (2, 100, 4, 128))
    wide = _randn(dev, 28, (2, 100, 4, 256), (2, 100, 4, 256))
    odd = torch.zeros(2, 100, 4, 129, device=dev, dtype=torch.bfloat16)
    cases = [(q, k, v), tuple(t.bfloat16() for t in (*wide, v)),
             tuple(t[..., :n].bfloat16().contiguous()
                   for t, n in ((q, 144), (k, 144), (v, 80))),
             (q.bfloat16(), k.bfloat16(), odd[..., :128])]
    for args in cases:
        before = fa_ops.flash_attention.launches
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.flash_attention(*args, causal=True)
        assert fa_ops.flash_attention.launches == before


def test_attention_tensor_core_kernel_is_deterministic(dev):
    """Two calls on the same inputs give the same bits (gemma2's local
    layer at one batch row): no block's result depends on the schedule."""
    q, k, v = _tc_inputs(dev, 23, 1, 4608, 4608, 8, 4, 256, 1.0)
    kw = dict(causal=True, window=4096, softcap=50.0)
    a = fa_ops.flash_attention(q, k, v, **kw)
    b = fa_ops.flash_attention(q, k, v, **kw)
    assert torch.equal(a, b)


def test_attention_tensor_core_kernel_takes_a_transposed_layout(dev):
    """(B, H, S, hd) storage seen as (B, S, H, hd): strides TMA addresses
    in another order."""
    q, k, v = (t.bfloat16().transpose(1, 2) for t in _randn(
        dev, 24, (2, 8, 100, 128), (2, 4, 100, 128), (2, 4, 100, 128)))
    before = fa_ops.flash_attention.launches_tensor_core
    out = fa_ops.flash_attention(q, k, v, causal=True, softcap=50.0)
    assert fa_ops.flash_attention.launches_tensor_core == before + 1
    assert _bf16_gates(out, _plain_attention(q, k, v, causal=True,
                                             softcap=50.0))


@pytest.mark.parametrize("layout", ["hd36", "padded_heads", "offset"])
def test_bf16_calls_the_tensor_cores_do_not_take_go_to_the_cuda_cores(
        dev, layout):
    """bf16 at head dim 36, with heads 136 bytes apart, or 8 bytes off
    16-byte alignment: the CUDA-core kernel, within the same gates."""
    hd = 36 if layout == "hd36" else 64
    width = hd + (4 if layout != "hd36" else 0)
    q, k, v = (t.bfloat16() for t in _randn(dev, 25, (2, 100, 8, width),
                                            (2, 100, 4, width),
                                            (2, 100, 4, width)))
    cut = slice(4, None) if layout == "offset" else slice(0, hd)
    q, k, v = q[..., cut], k[..., cut], v[..., cut]
    kw = dict(causal=True, window=40, softcap=50.0)
    before = fa_ops.flash_attention.launches_cuda_core
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.flash_attention.launches_cuda_core == before + 1
    assert _bf16_gates(out, _plain_attention(q, k, v, **kw))


def _short_check(q, k, v, **kw):
    """One call on the short-sequence kernel against the plain version:
    fp32 within 2e-5, bf16 within the bf16 gates."""
    fa = fa_ops.flash_attention
    before = (fa.launches_short, fa.launches_tensor_core, fa.launches_cuda_core)
    out = fa(q, k, v, **kw)
    assert (fa.launches_short, fa.launches_tensor_core,
            fa.launches_cuda_core) == (before[0] + 1, before[1], before[2])
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    ref = _plain_attention(q, k, v, **kw)
    if q.dtype == torch.float32:
        assert _err(out, ref) <= 2e-5
    else:
        assert _bf16_gates(out, ref)


@pytest.mark.parametrize("S", [1, 2, 16, 17, 31, 32])
@pytest.mark.parametrize("hd", [20, 32, 36, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_attention_kernel_matches_plain(dev, S, hd, dtype):
    """Non-causal attention over q, k, v as views of a (B, S, 3, H, hd) QKV
    buffer, as the DiT calls it, at lengths up to the kernel's 32 and head
    dims up to its 64 (20 and, in bf16, 36 are read one element at a
    time)."""
    (qkv,) = _randn(dev, 30, (6, S, 3, 4, hd))
    qkv = qkv.to(getattr(torch, dtype))
    _short_check(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)


SHORT_MODES = {"noncausal": dict(causal=False),
               "causal": dict(causal=True),
               "window": dict(causal=True, window=5),
               "softcap": dict(causal=False, softcap=50.0),
               "all": dict(causal=True, window=9, softcap=50.0)}


@pytest.mark.parametrize("mode", list(SHORT_MODES))
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1), (6, 3)])
@pytest.mark.parametrize("S,hd", [(17, 36), (32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_attention_kernel_modes_match_plain(dev, mode, Hq, Hkv, S, hd,
                                                  dtype):
    """Causal, window, softcap and GQA/MQA at the kernel's shapes; with the
    cap, q x 10 drives the scores to the cap's knee (v at half scale: near
    one-hot rows, see ``_tc_inputs``)."""
    kw = SHORT_MODES[mode]
    sharp = 10.0 if kw.get("softcap") else 1.0
    q, k, v = _randn(dev, 31, (3, S, Hq, hd), (3, S, Hkv, hd),
                     (3, S, Hkv, hd))
    dt = getattr(torch, dtype)
    _short_check((q * sharp).to(dt), k.to(dt),
                 (v * (0.5 if sharp > 1 else 1.0)).to(dt), **kw)


@pytest.mark.parametrize("layout", ["qkv_views", "contiguous", "bhsd",
                                    "unaligned", "sq_ne_sk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_attention_kernel_layouts(dev, layout, dtype):
    """The DiT's QKV views, contiguous tensors, (B, H, S, hd) storage seen as
    (B, S, H, hd), views two elements off 16-byte alignment (read one
    element at a time) and fewer keys than queries."""
    dt = getattr(torch, dtype)
    Sk = 9 if layout == "sq_ne_sk" else 17
    if layout == "qkv_views":
        (qkv,) = _randn(dev, 32, (5, 17, 3, 4, 32))
        q, k, v = qkv.to(dt).unbind(2)
    elif layout == "bhsd":
        q, k, v = (t.to(dt).transpose(1, 2) for t in _randn(
            dev, 32, (5, 4, 17, 32), (5, 2, 17, 32), (5, 2, 17, 32)))
    elif layout == "unaligned":
        q, k, v = (t.to(dt)[..., 2:] for t in _randn(
            dev, 32, (5, 17, 4, 38), (5, 17, 2, 38), (5, 17, 2, 38)))
        assert not any(fa_kernel.vector_loads(t) for t in (q, k, v))
    else:
        q, k, v = (t.to(dt) for t in _randn(
            dev, 32, (5, 17, 4, 32), (5, Sk, 2, 32), (5, Sk, 2, 32)))
    _short_check(q, k, v, causal=False)


def test_short_attention_kernel_is_bit_equal_to_itself(dev):
    (qkv,) = _randn(dev, 33, (256, 17, 3, 4, 36))
    q, k, v = qkv.unbind(2)
    a = fa_ops.flash_attention(q, k, v, causal=False)
    assert torch.equal(a, fa_ops.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("Sq,Sk,hd,dtype,route", [
    (32, 32, 64, "float32", "short"), (33, 33, 64, "float32", "cuda_core"),
    (17, 40, 36, "float32", "cuda_core"), (32, 32, 80, "float32", "cuda_core"),
    (32, 32, 64, "bfloat16", "short"), (33, 33, 64, "bfloat16", "tensor_core"),
    (32, 32, 80, "bfloat16", "tensor_core")])
def test_attention_routes_by_length_and_head_dim(dev, Sq, Sk, hd, dtype,
                                                 route):
    """S 32 against 33 and hd 64 against 65+: the short kernel takes Sq, Sk
    <= 32 and hd <= 64, and every other call goes where it went before it
    (fp32 to the CUDA cores, bf16 at hd % 16 == 0 to the tensor cores);
    the counters move with the route and the result holds either way."""
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _randn(dev, 34, (2, Sq, 4, hd),
                                        (2, Sk, 4, hd), (2, Sk, 4, hd)))
    fa = fa_ops.flash_attention
    names = ("short", "tensor_core", "cuda_core")
    before = [getattr(fa, f"launches_{n}") for n in names]
    out = fa(q, k, v, causal=False)
    moved = [getattr(fa, f"launches_{n}") - b for n, b in zip(names, before)]
    assert moved == [int(n == route) for n in names]
    ref = _plain_attention(q, k, v, causal=False)
    assert _err(out.float(), ref.float()) <= (2e-5 if dtype == "float32"
                                              else 2e-2)


# (causal, window, softcap, query heads, kv heads, q scale) for the CUDA-core
# kernel's grid; q x 10 puts the capped scores at the cap's knee
CC_MODES = {"noncausal": (False, 0, 0.0, 4, 4, 1.0),
            "causal": (True, 0, 0.0, 4, 4, 1.0),
            "causal_window": (True, 40, 0.0, 4, 4, 1.0),
            "gqa_window_cap": (True, 40, 50.0, 4, 2, 10.0),
            "mqa_cap": (False, 0, 50.0, 4, 1, 10.0)}


def _cuda_core_check(q, k, v, **kw):
    """One call on the CUDA-core kernel against the plain version: fp32
    within 2e-5, bf16 within the bf16 gates."""
    fa = fa_ops.flash_attention
    names = ("short", "tensor_core", "cuda_core")
    before = [getattr(fa, f"launches_{n}") for n in names]
    out = fa(q, k, v, **kw)
    assert [getattr(fa, f"launches_{n}") - b
            for n, b in zip(names, before)] == [0, 0, 1]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    ref = _plain_attention(q, k, v, **kw)
    if q.dtype == torch.float32:
        assert _err(out, ref) <= 2e-5
    else:
        assert _bf16_gates(out, ref)


@pytest.mark.parametrize("mode", list(CC_MODES))
@pytest.mark.parametrize("S", [33, 63, 64, 65, 127, 128, 129, 3137])
@pytest.mark.parametrize("hd,dtype", [
    (32, "float32"), (36, "float32"), (64, "float32"), (80, "float32"),
    (128, "float32"), (256, "float32"), (36, "bfloat16"), (40, "bfloat16"),
    (200, "bfloat16")])
def test_cuda_core_kernel_at_tile_edges(dev, mode, S, hd, dtype):
    """The CUDA-core kernel at lengths one short of, on and one past its
    query and key tiles (32 to 128 keys, 64 or 128 query rows) and at the
    DiT's 3137, in every head-dim class the DiT and the LM reach, every
    mode: fp32, and bf16 at head dims the tensor cores do not take."""
    causal, window, softcap, Hq, Hkv, q_scale = CC_MODES[mode]
    B = 1 if S > 1000 else 2
    q, k, v = _randn(dev, 40, (B, S, Hq, hd), (B, S, Hkv, hd),
                     (B, S, Hkv, hd))
    dt = getattr(torch, dtype)
    v = v * (0.5 if q_scale > 1 else 1.0)
    _cuda_core_check((q * q_scale).to(dt), k.to(dt), v.to(dt),
                     causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("Hq,Hkv,hd,causal", [(16, 16, 80, False),
                                              (14, 2, 80, False),
                                              (14, 2, 64, True),
                                              (16, 16, 80, True)])
@pytest.mark.parametrize("S", [65, 1024])
def test_cuda_core_kernel_at_the_frontend_models_shapes(dev, Hq, Hkv, hd,
                                                        causal, S):
    """The CUDA-core kernel in fp32 (the LMs' fp32 kernel route) at
    hubert-xlarge's heads (16/16 of 80, the class of 96: columns 80-95
    zeros), non-causal as its encoder runs, and internvl2-1b's GQA 14/2 (a
    kv head h / 7; a block takes one query head, 7 not a power of two),
    against the plain version at 2e-5."""
    q, k, v = _randn(dev, 41, (2, S, Hq, hd), (2, S, Hkv, hd),
                     (2, S, Hkv, hd))
    _cuda_core_check(q, k, v, causal=causal, window=0, softcap=0.0)


@pytest.mark.parametrize("layout", ["qkv_views", "bhsd", "unaligned",
                                    "odd_hd", "sq_ne_sk", "sk_lt_sq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_core_kernel_layouts(dev, layout, dtype):
    """Strides and lengths past the contiguous case: the DiT's QKV views,
    (B, H, S, hd) storage seen as (B, S, H, hd), views 8 bytes off 16-byte
    alignment and a head dim of 37 (copied one element at a time), and
    fewer or more keys than queries."""
    dt = getattr(torch, dtype)
    kw = dict(causal=False)
    if layout == "qkv_views":
        (qkv,) = _randn(dev, 41, (3, 200, 3, 4, 36))
        q, k, v = qkv.to(dt).unbind(2)
    elif layout == "bhsd":
        q, k, v = (t.to(dt).transpose(1, 2) for t in _randn(
            dev, 41, (2, 4, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64)))
        kw = dict(causal=True, window=50)
    elif layout in ("unaligned", "odd_hd"):
        cut = slice(2, 66) if layout == "unaligned" else slice(0, 37)
        q, k, v = (t.to(dt)[..., cut] for t in _randn(
            dev, 41, (2, 150, 4, 68), (2, 150, 2, 68), (2, 150, 2, 68)))
        kw = dict(causal=True, softcap=50.0)
        assert not any(fa_kernel.vector_loads(t) for t in (q, k, v))
    else:
        Sk = 300 if layout == "sq_ne_sk" else 70
        q, k, v = (t.to(dt) for t in _randn(
            dev, 41, (2, 150, 4, 64), (2, Sk, 4, 64), (2, Sk, 4, 64)))
    if dt == torch.bfloat16 and fa_kernel.tensor_core_route(q, k, v):
        q, k, v = (t[..., :36] for t in (q, k, v))  # keep off the tensor cores
    _cuda_core_check(q, k, v, **kw)


def test_cuda_core_kernel_is_bit_equal_to_itself(dev):
    """Two calls on the same inputs give the same bits, at the DiT's 224-px
    shape and at 8c's layer (cut to 1024 tokens): row sums are added in a
    fixed order, no atomics."""
    (qkv,) = _randn(dev, 42, (2, 3137, 3, 4, 32))
    q, k, v = qkv.unbind(2)
    a = fa_ops.flash_attention(q, k, v, causal=False)
    assert torch.equal(a, fa_ops.flash_attention(q, k, v, causal=False))
    q, k, v = _randn(dev, 43, (1, 1024, 8, 256), (1, 1024, 4, 256),
                     (1, 1024, 4, 256))
    kw = dict(causal=True, window=512, softcap=50.0)
    a = fa_ops.flash_attention(q, k, v, **kw)
    assert torch.equal(a, fa_ops.flash_attention(q, k, v, **kw))


def test_decode_contracts_the_bf16_cache_in_place(dev):
    """Decode's contractions over a bf16 cache on the card (``bmm`` with an
    fp32 output) against the same contractions on fp32 copies: the same
    products (a bf16 product is exact in fp32) summed in another order, so
    within 1e-5 of the largest value; the attention output within the bf16
    gates.  And no fp32 copy of the cache is made: the call's peak memory
    stays below a quarter of one."""
    cfg = get_config("gemma2-2b")
    B, S, Hq, Hkv, hd = 4, 4640, cfg.num_heads, cfg.num_kv_heads, 256
    q, k, v = (t.bfloat16() for t in _randn(dev, 35, (B, 1, Hq, hd),
                                            (B, S, Hkv, hd), (B, S, Hkv, hd)))
    qs = (q * hd ** -0.5).reshape(B, 1, Hkv, Hq // Hkv, hd)
    logits = lm_attention._scores_f32(qs, k)
    ref = torch.einsum("bqhrd,bkhd->bhrqk", qs.float(), k.float())
    assert logits.dtype == torch.float32
    assert _err(logits, ref) <= 1e-5 * float(ref.abs().max())
    p = torch.softmax(ref, -1).bfloat16()
    mixed = lm_attention._mix_f32(p, v)
    ref = torch.einsum("bhrqk,bkhd->bqhrd", p.float(), v.float())
    assert _err(mixed, ref) <= 1e-5 * float(ref.abs().max())
    mask = (torch.arange(S, device=dev) <= 4000)[None, None].expand(B, 1, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = lm_attention._attend(q, k, v, mask, cfg, 0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - start < k.numel() * 4 / 4
    scale = hd ** -0.5
    s32 = torch.einsum("bqhrd,bkhd->bhrqk",
                       (q * scale).reshape(B, 1, Hkv, -1, hd).float(),
                       k.float())
    s32 = cfg.attn_softcap * torch.tanh(s32 / cfg.attn_softcap)
    s32 = s32.masked_fill(~mask[:, None, None], lm_attention.NEG)
    p32 = torch.softmax(s32, -1).bfloat16().float()
    ref = torch.einsum("bhrqk,bkhd->bqhrd", p32, v.float()).bfloat16()
    assert _bf16_gates(out.reshape(B, 1, Hq, hd), ref.reshape(B, 1, Hq, hd))


@pytest.mark.parametrize("d", [1, 7, 100, 2303, 2304, 4100, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_at_odd_widths_and_both_scale_types(dev, d, dtype,
                                                           scale_dtype):
    """Widths that are not whole 16-byte chunks (one element at a time),
    one and several warps a row, fp32 and bf16 scales."""
    x, s = _randn(dev, 44, (37, d), (d,))
    x = x.to(getattr(torch, dtype))
    s = (0.1 * s).to(getattr(torch, scale_dtype))
    out = rn_ops.rmsnorm(x, s)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    assert out.dtype == x.dtype
    assert _err(out.float(), rn_ref.rmsnorm(x, s).float()) <= tol


@pytest.mark.parametrize("view", ["padded_rows", "offset", "aligned_slice"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_on_strided_rows(dev, view, dtype):
    """Rows further apart than d, with and without 16-byte alignment."""
    (buf,) = _randn(dev, 45, (300, 2320))
    buf = buf.to(getattr(torch, dtype))
    x = {"padded_rows": buf[:, :2310], "offset": buf[:, 3:2307],
         "aligned_slice": buf[:, 8:2312]}[view]
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    assert rn_kernel.vector_route(x) == (view == "aligned_slice")
    (s,) = _randn(dev, 46, (x.shape[1],))
    out = rn_ops.rmsnorm(x, 0.1 * s)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    assert out.is_contiguous()
    assert _err(out.float(), rn_ref.rmsnorm(x, 0.1 * s).float()) <= tol


@pytest.mark.parametrize("shape", [(18432, 2304), (5, 96), (3, 7, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    x, s = _randn(dev, 13, shape, shape[-1:])
    x = x.to(getattr(torch, dtype))
    before = rn_ops.rmsnorm.launches
    out = rn_ops.rmsnorm(x, 0.1 * s)
    assert rn_ops.rmsnorm.launches == before + 1
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    assert _err(out.float(), rn_ref.rmsnorm(x, 0.1 * s).float()) <= tol


def test_serve_engine_kernel_route_matches_plain_route(dev):
    """A 2-layer gemma2 at full width in fp32 on key-drawn weights: the same
    waves (16-token prompts past a window of 8, and 40-token ones) through
    the flash kernel and through the plain route give the same tokens,
    with one kernel launch per layer and wave and none in decode.  A
    random-weight model's greedy tokens tell little (they repeat one
    token), so the prefill's last-position logits of the two routes are
    held too, at 1e-3: each attention layer differs by ~1e-6 relative
    (fp32 sums in another order) and |logit| < 30 after the final soft
    cap."""
    cfg = get_config("gemma2-2b").replace(num_layers=2, dtype="float32",
                                          sliding_window=8)
    lm = init_lm(prng.PRNGKey(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (16, 16, 40)]
    toks = torch.as_tensor(np.stack(prompts[:2]), device=dev)
    out, last = {}, {}
    for use_kernels in (True, False):
        par = Parallel(use_kernels=use_kernels, prefill_last_only=True)
        with torch.inference_mode():
            last[use_kernels] = lm(toks, par, mode="prefill")[0][:, -1]
        eng = ServeEngine(cfg, lm, max_len=64, par=par)
        rids = [eng.submit(p, max_new=4) for p in prompts]
        before = fa_ops.flash_attention.launches
        res = eng.run()
        launched = fa_ops.flash_attention.launches - before
        assert launched == (2 * cfg.num_layers if use_kernels else 0)
        assert eng.stats == {"waves": 2, "prefilled": 3, "decoded": 9}
        out[use_kernels] = [res[r] for r in rids]
    assert float(last[False].abs().max()) > 1e-2
    assert _err(last[True], last[False]) < 1e-3
    assert out[True] == out[False]


def test_sample_cfg_kernel_path_matches_plain(dev):
    """The kernel path against a copy of the model that runs the plain DiT,
    on the same x_T and noise.  Both take the cfg_update kernel, which is
    bit-equal to its plain version (``test_cfg_update_kernel_matches_plain``
    at the first step of this trajectory)."""
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4)
    model = init_dit(prng.PRNGKey(0), dc, 16, 3, device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 10 + i, p.shape)[0])
    plain = copy.deepcopy(model)
    plain.plain = True
    y, x_T, noise = _randn(dev, 4, (8, 512), (8, 16, 16, 3),
                           (4, 8, 16, 16, 3))
    sched = make_schedule(device=dev)
    fns = (cfg_ops.cfg_update, an_ops.adaln_norm, fa_ops.flash_attention)
    before = [f.launches for f in fns]
    out = sample_cfg(model, sched, y, num_steps=4, x_T=x_T, noise=noise)
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 4 * 5, 4 * 2]
    ref = sample_cfg(plain, sched, y, num_steps=4, x_T=x_T, noise=noise)
    assert [f.launches - b for f, b in zip(fns, before)] == [8, 4 * 5, 4 * 2]
    assert float(ref.abs().max()) > 1e-3
    assert _err(out, ref) < 5e-4


def test_ragged_wave_kernel_path_matches_plain(dev):
    """A 4-step ragged wave at mixed (guidance, steps) on the kernel path
    against a copy of the model that runs the plain DiT, from the same row
    keys; the rowwise update kernel runs once per iteration."""
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4)
    model = init_dit(prng.PRNGKey(0), dc, 16, 3, device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 10 + i, p.shape)[0])
    plain = copy.deepcopy(model)
    plain.plain = True
    (y,) = _randn(dev, 6, (8, 512))
    g = np.array([1.5, 4.0, 7.5, 1.5] * 2, np.float32)
    steps = np.array([4, 4, 2, 2] * 2)
    keys = prng.split(prng.PRNGKey(3), 8)
    sched = make_schedule(device=dev)
    before = cfg_ops.cfg_update_rowwise.launches
    out = sample_cfg_ragged(model, sched, y, keys, g, steps)
    assert cfg_ops.cfg_update_rowwise.launches == before + 4
    ref = sample_cfg_ragged(plain, sched, y, keys, g, steps)
    assert float(ref.abs().max()) > 1e-3
    assert _err(out, ref) < 5e-4


def _seeded_dit(dev):
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4)
    model = init_dit(prng.PRNGKey(0), dc, 16, 3, device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 10 + i, p.shape)[0])
    return model


def test_sample_cfg_draws_its_noise_in_the_kernel(dev):
    """A uniform wave from a key on the card hands each step's key to the
    kernel (4 keyed launches, no noise drawn before the loop) and gives
    the bits of the same wave fed x_T and the step noise drawn by
    ``prng.normal`` from the same split chain."""
    model = _seeded_dit(dev)
    (y,) = _randn(dev, 4, (8, 512))
    sched = make_schedule(device=dev)
    key = prng.PRNGKey(5)
    n0 = (cfg_ops.cfg_update.launches, cfg_ops.cfg_update.launches_keyed)
    out = sample_cfg(model, sched, y, key, num_steps=4)
    assert (cfg_ops.cfg_update.launches - n0[0],
            cfg_ops.cfg_update.launches_keyed - n0[1]) == (4, 4)
    k, k0 = prng.split(key)
    chain = []
    for _ in range(4):
        k, kn = prng.split(k)
        chain.append(kn)
    draws = prng.normal(np.stack([k0, *chain]), (8, 16, 16, 3), dev)
    ref = sample_cfg(model, sched, y, num_steps=4, x_T=draws[0],
                     noise=draws[1:])
    assert torch.equal(out, ref)


def test_ragged_wave_draws_its_noise_in_the_kernel(dev):
    """A ragged wave's rows draw their step noise in the rowwise kernel
    from their keys; the same rows as a mixed wave of classifier-free
    rows only (the mixed kernel, keyed too, bit-equal to the rowwise one
    at mode 0) give the same bits."""
    model = _seeded_dit(dev)
    (y,) = _randn(dev, 6, (8, 512))
    g = np.array([1.5, 4.0, 7.5, 1.5] * 2, np.float32)
    steps = np.array([4, 4, 2, 2] * 2)
    keys = prng.split(prng.PRNGKey(3), 8)
    sched = make_schedule(device=dev)
    n0 = cfg_ops.cfg_update_rowwise.launches_keyed
    out = sample_cfg_ragged(model, sched, y, keys, g, steps)
    assert cfg_ops.cfg_update_rowwise.launches_keyed == n0 + 4
    ref = sample_mixed(model, sched, y, keys, g, np.zeros(8, np.float32),
                       None, None, steps)
    assert torch.equal(out, ref)


def test_mixed_wave_draws_its_noise_in_the_kernel(dev, monkeypatch):
    """A mixed wave with classifier-guided rows hands each iteration's row
    keys to the mixed kernel (one keyed launch an iteration) and gives the
    bits of the same wave whose updates are fed ``prng.normal`` of those
    keys times live, drawn outside the kernel."""
    model = _seeded_dit(dev)
    (y,) = _randn(dev, 9, (8, 512))
    clf = classifier_logprob(init_classifier(prng.PRNGKey(3), "resnet18", 10, device=dev))
    g = np.array([1.5, 4.0, 1.0, 1.0, 0.0, 7.5, 1.0, 0.0], np.float32)
    mode = np.array([0, 0, 1, 1, 0, 0, 1, 0], np.float32)
    steps = np.array([4, 4, 2, 4, 2, 2, 4, 4])
    keys = prng.split(prng.PRNGKey(4), 8)
    labels = np.arange(8) % 10
    sched = make_schedule(device=dev)

    def wave():
        return sample_mixed(model, sched, y, keys, g, mode, np.zeros(8),
                            labels, steps, clf_fns=(clf,))

    fn = cfg_ops.cfg_update_mixed
    n0 = (fn.launches, fn.launches_keyed)
    out = wave()
    assert (fn.launches - n0[0], fn.launches_keyed - n0[1]) == (4, 4)
    flat, drawn = cfg_kernel.cfg_update_mixed_flat, []

    def drawn_outside(x, ec, eu, noise, coeffs, row_offset, *, keys=None,
                      live=None):
        drawn.append(keys is not None)
        z = cfg_ref.row_noise(keys, live, x.shape[1:], x.device)
        return flat(x, ec, eu, z, coeffs, row_offset)

    monkeypatch.setattr(cfg_kernel, "cfg_update_mixed_flat", drawn_outside)
    ref = wave()
    assert drawn == [True] * 4
    assert float(ref.abs().max()) > 1e-3
    assert torch.equal(out, ref)


def test_classifier_gradient_of_a_row_does_not_depend_on_its_batch(dev):
    """cuDNN picks its algorithms by batch size; the guidance gradient runs
    the classifier on fixed-size chunks, so a row's gradient is the same
    bits in a call of 5 rows, of 120, or across a chunk boundary."""
    from repro_torch.diffusion.guidance import _logprob_grad
    clf = init_classifier(prng.PRNGKey(3), "resnet18", 10, device=dev)
    fn = classifier_logprob(clf)
    (x,) = _randn(dev, 8, (200, 16, 16, 3))
    labels = torch.arange(200, device=dev) % 10
    full = _logprob_grad(fn, x, labels)
    for rows in (slice(0, 5), slice(0, 120), slice(100, 200)):
        assert torch.equal(_logprob_grad(fn, x[rows], labels[rows]),
                           full[rows])


def _relu_signs(fn):
    """``fn()`` with the sign of every ReLU input it computed, on the
    host."""
    signs = []
    with recorded_relu(lambda v: signs.append((v > 0).cpu())):
        return fn(), signs


def test_classifier_guided_on_the_card_matches_the_cpu_run(dev):
    """Four classifier-guided steps (a ResNet-18's gradient at each) on the
    card against the same model, classifier, x_T and noise on the CPU, at
    T = 16, the CPU tests' smoke depth and gate.  A ReLU input of the
    classifier on one side of 0 on the card and on the other on the CPU
    moves a guidance gradient by a step, not by rounding, so the test
    takes the first classifier key whose two runs put every ReLU input on
    the same side of 0, as ``test_train_classifier_on_the_card_matches_
    the_cpu`` takes its data seed, and says which."""
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4,
                         train_timesteps=16)
    model = init_dit(prng.PRNGKey(0), dc, 16, 3, device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 10 + i, p.shape)[0])
    cpu_model = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn((8, 16, 16, 3), generator=gen)
    noise = torch.randn((4, 8, 16, 16, 3), generator=gen)
    labels = np.arange(8) % 10

    def guided(m, clf, where):
        return sample_classifier_guided(
            m, make_schedule(16, device=where), classifier_logprob(clf),
            labels, num_steps=4, guidance=1.0, x_T=x_T.to(where),
            noise=noise.to(where))

    crossed = {}
    for ck in range(1, 9):
        clf = init_classifier(prng.PRNGKey(ck), "resnet18", 10, device=dev)
        cpu_clf = copy.deepcopy(clf).cpu()
        (out, s_card), (ref, s_cpu) = (
            _relu_signs(lambda: guided(model, clf, dev)),
            _relu_signs(lambda: guided(cpu_model, cpu_clf, "cpu")))
        assert len(s_card) == len(s_cpu)
        crossed[ck] = sum(int((a != b).sum()) for a, b in zip(s_card, s_cpu))
        if crossed[ck] == 0:
            break
    assert crossed[ck] == 0, f"ReLU inputs crossing 0 by key: {crossed}"
    assert out.device.type == "cuda" and out.shape == (8, 16, 16, 3)
    assert float(ref.abs().max()) > 1e-3
    assert _err(out.cpu(), ref) < 5e-4, f"classifier key {ck}"


def test_category_encodings_repeat_bit_for_bit(dev):
    """The per-category sum has a fixed order on the card (a one-hot
    product, not float atomics): repeated calls give the same bits, and
    the CPU's values within the reference gate."""
    from repro_torch.encoders.foundation import FrozenFM, category_encodings
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (100, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 100)
    labels[labels == 7] = 3                     # category 7 absent
    fm = FrozenFM()
    runs = [category_encodings(fm, torch.as_tensor(images, device=dev),
                               labels, 10) for _ in range(3)]
    for mean, present in runs[1:]:
        assert torch.equal(mean, runs[0][0])
        assert torch.equal(present, runs[0][1])
    cpu_mean, cpu_present = category_encodings(FrozenFM(),
                                               torch.from_numpy(images),
                                               labels, 10)
    assert torch.equal(runs[0][1].cpu(), cpu_present) and not cpu_present[7]
    assert _err(runs[0][0].cpu(), cpu_mean) < 1e-5


@pytest.mark.parametrize("name", ["resnet18", "vit_b16"])
def test_train_classifier_on_the_card_matches_the_cpu(dev, name):
    """Three SGD steps from one init and one key, card against CPU, within
    the classifier's card-against-CPU gate.  A ReLU input that lies on one
    side of 0 on the card and on the other on the CPU moves a ResNet-18's
    gradient by a step (~0.09), not by rounding, and which inputs cross
    depends on the data, the init and each device's rounding (a CPU margin
    of 1e-6 did not rule it out), so the test takes the first data seed
    whose two runs put every ReLU input on the same side of 0, as
    ``chip_smoke.py`` phase 9.2 takes its key, and says which."""
    from repro_torch.core import classifier_train as ct
    key = prng.PRNGKey(5)
    crossed = {}
    for seed in range(16):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, (32, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 10, 32)
        runs = [_relu_signs(lambda: ct.train_classifier(
            init_classifier(key, name, 10, device=d), name, x, y, key, steps=3,
            batch=16)) for d in ("cpu", dev)]
        (cpu, s_cpu), (card, s_card) = runs
        assert len(s_cpu) == len(s_card)
        crossed[seed] = sum(int((a != b).sum()) for a, b in zip(s_cpu,
                                                                 s_card))
        if crossed[seed] == 0:
            break
    assert crossed[seed] == 0, f"ReLU inputs crossing 0 by seed: {crossed}"
    pc, pg = cpu.state_dict(), card.state_dict()
    assert all(v.device.type == dev.type for v in pg.values())
    assert max(_err(pg[k].cpu(), pc[k]) for k in pc) < 1e-4, f"seed {seed}"
    with torch.no_grad():
        assert abs(float(ct.xent(card, name, x, y))
                   - float(ct.xent(cpu, name, x, y))) < 1e-4
    # the same key on the card gives the same bits
    again = ct.train_classifier(init_classifier(key, name, 10, device=dev),
                                name, x, y, key, steps=3, batch=16)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in pg.items())


def _smoke_oscar(dev):
    from repro_torch.configs.oscar import DataConfig, OscarConfig
    from repro_torch.data.federated import make_federated_data
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4,
                         sample_timesteps=4)
    data_cfg = DataConfig(num_categories=3, num_domains=2,
                          train_per_cat_dom=3, test_per_cat_dom=4)
    ocfg = OscarConfig(data=data_cfg, diffusion=dc, samples_per_category=3,
                       classifier_steps=2, classifier_batch=8)
    return ocfg, make_federated_data(data_cfg), _seeded_dit(dev).eval()


def test_run_oscar_repeats_bit_for_bit_from_one_key(dev):
    from repro_torch.core.oscar import run_oscar
    from repro_torch.encoders.foundation import FrozenFM
    ocfg, data, model = _smoke_oscar(dev)
    sched = make_schedule(device=dev)
    runs = [run_oscar(prng.PRNGKey(3), ocfg, data, model, sched, FrozenFM())
            for _ in range(2)]
    a, b = runs
    assert a.syn_images.device.type == dev.type
    assert a.syn_images.shape == (18, 16, 16, 3)
    assert torch.equal(a.syn_images, b.syn_images)
    assert np.array_equal(a.encodings, b.encodings)
    pa, pb = a.global_params.state_dict(), b.global_params.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert a.metrics == b.metrics and 0 <= a.metrics["avg"] <= 1


def test_2d_requests_give_their_rows_in_grouped_and_ragged_waves(dev):
    """FedDISC's 2-D requests on the card: a grouped wave is
    ``sample_cfg`` over the wave's rows in order from the wave key, a
    ragged wave ``sample_cfg_ragged`` over the same rows with each row's
    own key, bit for bit."""
    from repro_torch.serve.synthesis import SynthesisEngine
    model = _seeded_dit(dev).eval()
    sched = make_schedule(device=dev)
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((10, 512)).astype(np.float32)
    one = rng.standard_normal(512).astype(np.float32)
    key = prng.PRNGKey(8)
    cond = np.concatenate([enc, np.repeat(one[None], 4, 0)])
    waves = [cond[:8], np.concatenate([cond[8:], cond[-1:].repeat(2, 0)])]
    outs = {}
    for name, ragged in (("grouped", False), ("ragged", True)):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              ragged=ragged)
        eng.submit(enc, 0, num_steps=3)
        eng.submit(one, 1, 4, num_steps=3)
        out = eng.run(key)
        outs[name] = torch.cat([out[0], out[1]])
    want = torch.cat([sample_cfg(model, sched, w, prng.fold_in(key, i),
                                 num_steps=3) for i, w in enumerate(waves)])
    assert torch.equal(outs["grouped"], want[:14])
    rids = np.array([0] * 10 + [1] * 6)
    ridx = np.concatenate([np.arange(10), np.arange(4), [3, 3]])
    row_keys = prng.fold_in(prng.fold_in(key[None], rids), ridx)
    want = torch.cat([sample_cfg_ragged(
        model, sched, w, row_keys[8 * i:8 * i + 8],
        np.full(8, 2.0, np.float32), np.full(8, 3, np.int32))
        for i, w in enumerate(waves)])
    assert torch.equal(outs["ragged"], want[:14])
    assert float((outs["ragged"][0] - outs["ragged"][1]).abs().max()) > 1e-3


def test_a_traced_drain_times_each_wave_on_the_card(dev):
    """With its tracer on, a grouped drain records one ``wave.device``
    instant a wave from CUDA timing events: the wave's device time above
    0 and, from the second wave on, the device's gap after the previous
    wave, at least 0.  D_syn is the untraced drain's, bit for bit."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.synthesis import SynthesisEngine
    model = _seeded_dit(dev).eval()
    sched = make_schedule(device=dev)
    enc = np.random.default_rng(7).standard_normal(512).astype(np.float32)
    outs = {}
    for traced in (False, True):
        tr = Tracer(enabled=traced)
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              tracer=tr)
        rid = eng.submit(enc, 0, 24, num_steps=3)
        outs[traced] = eng.run(prng.PRNGKey(9))[rid]
    assert torch.equal(outs[False], outs[True])
    waves = [s for s in tr.spans if s.name == "wave.device"]
    assert [s.attrs["wave"] for s in waves] == [0, 1, 2]
    assert sum(s.name == "wave.pack" for s in tr.spans) == 3
    assert all(s.attrs["device_ms"] > 0 for s in waves)
    assert "gap_ms" not in waves[0].attrs
    assert all(s.attrs["gap_ms"] >= 0 for s in waves[1:])


def test_inits_from_a_key_on_the_card_equal_the_cpu_draws(dev):
    key = prng.PRNGKey(5)
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4)
    pairs = [[init_dit(key, dc, 16, 3, device=d).state_dict()
              for d in (dev, "cpu")]]
    pairs += [[init_classifier(key, name, 10, device=d).state_dict()
               for d in (dev, "cpu")] for name in ("resnet18", "vit_b16")]
    for on_card, on_cpu in pairs:
        assert sorted(on_card) == sorted(on_cpu)
        for k, v in on_card.items():
            assert v.device.type == "cuda"
            assert torch.equal(v.cpu(), on_cpu[k]), k


def test_pretraining_repeats_bit_for_bit_on_the_card(dev):
    from repro_torch.diffusion.ddpm import pretrain_dm
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4,
                         batch_size=32)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (64, 16, 16, 3)).astype(np.float32)
    y = rng.standard_normal((64, 512)).astype(np.float32)
    groups = np.arange(64) % 6
    fns = (an_ops.adaln_norm, fa_ops.flash_attention)
    before = [f.launches for f in fns]
    runs = [pretrain_dm(prng.PRNGKey(9), dc, x, y, image_size=16,
                        channels=3, steps=5, groups=groups, device=dev)
            for _ in range(2)]
    # training runs the plain route: no kernel launched
    assert [f.launches for f in fns] == before
    (a, _, la), (b, _, lb) = runs
    assert la == lb and len(la) == 5
    assert not a.plain and a.null_y.device.type == "cuda"
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(sa["patch_out.weight"].abs().max()) > 0
    # the trained model samples through the kernels: 2L + 1 adaLN sites
    # and L attentions a call
    (x_t,) = _randn(dev, 5, (4, 16, 16, 3))
    with torch.inference_mode():
        a(x_t, torch.arange(4, device=dev), torch.as_tensor(y[:4],
                                                            device=dev))
    assert [f.launches - n for f, n in zip(fns, before)] == [5, 2]


def test_grad_through_the_kernel_route_still_raises(dev):
    """Pretraining runs the plain route because the kernels have no
    backward: a DiT on the kernel route refuses a loss with grad."""
    from repro_torch.diffusion.ddpm import diffusion_loss
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4)
    model = init_dit(prng.PRNGKey(2), dc, 16, 3, device=dev)
    x, y = _randn(dev, 3, (4, 16, 16, 3), (4, 512))
    sched = make_schedule(device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        diffusion_loss(model, dc, sched, x, y, prng.PRNGKey(1))
    model.plain = True
    loss = diffusion_loss(model, dc, sched, x, y, prng.PRNGKey(1))
    assert loss.requires_grad and torch.isfinite(loss)


# -- slice 12: init_lm on the card, the service and its store ------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix, tree


def test_init_lm_on_the_card_draws_the_cpu_bits(dev):
    """``init_lm`` draws on the device it is given: on the card the random
    bits equal the CPU's, and every weight is within 4 ulps of the CPU
    draw (erfinv's log1p and sqrt round otherwise on the card; measured at
    most 3 ulps on an NVIDIA H100 80GB HBM3 at 700 W), zeros exactly; the
    model holds the tree's values."""
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.convert import lm_state_from_jax
    from repro_torch.models.transformer import init_lm_tree
    cfg = smoke_config(get_config("gemma2-2b")).replace(
        qkv_bias=True, qk_norm=True, tie_embeddings=False)
    key = prng.PRNGKey(11)
    keys = prng.split(key, 3)
    assert torch.equal(prng.random_bits(keys, (4099,), dev).cpu(),
                       prng.random_bits(keys, (4099,), "cpu"))
    card, cpu = (dict(_leaves(init_lm_tree(key, cfg, d)))
                 for d in (dev, "cpu"))
    assert sorted(card) == sorted(cpu)
    worst = 0
    for name, a in card.items():
        a, b = a.cpu(), cpu[name]
        assert a.shape == b.shape and a.device.type == "cpu"
        same_sign = torch.sign(a) == torch.sign(b)
        assert bool(same_sign.all()), name
        gap = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        worst = max(worst, int(gap.max()) if gap.numel() else 0)
    print(f"init_lm card vs CPU: at most {worst} ulps")
    assert worst <= 4, worst
    lm = init_lm(key, cfg, device=dev)
    want = lm_state_from_jax(init_lm_tree(key, cfg, dev), cfg)
    assert all(torch.equal(v, want[k].to(v.dtype))
               for k, v in lm.state_dict().items())


_STORE_CHILD = """
import hashlib, sys
import numpy as np, torch
from repro_torch import prng
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels.adaln_norm import ops as an_ops
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.serve import SynthesisEngine, SynthesisService, SynthesisStore
root = sys.argv[1]
model = DiT(DiffusionConfig(d_model=144, num_layers=2, num_heads=4), 16, 3,
            device="cuda")
model.load_state_dict(torch.load(root + "/dit.pt"))
enc = np.load(root + "/enc.npy")
svc = SynthesisService(SynthesisEngine(model, make_schedule(device="cuda"),
                                       image_size=16, wave_size=8,
                                       ragged=True),
                       key=3, store=SynthesisStore(root + "/store"))
futs = [svc.submit(e, i, 5, guidance=2.0, num_steps=4)
        for i, e in enumerate(enc)]
rows = torch.cat(svc.gather(futs))
fns = (fa_ops.flash_attention, an_ops.adaln_norm, cfg_ops.cfg_update,
       cfg_ops.cfg_update_rowwise, cfg_ops.cfg_update_mixed)
print(hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest(),
      sum(f.launches for f in fns), svc.stats["waves"],
      svc.stats["store_hits"])
"""


def test_a_warm_store_serves_a_cold_process_with_no_launch(dev, tmp_path):
    """A ragged service round on the card fills a store; a child process
    with a fresh engine on the same store serves the same requests from it
    with no wave and no kernel launch, the rows' SHA-256 equal."""
    import hashlib
    import os
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.serve import (SynthesisEngine, SynthesisService,
                                   SynthesisStore)
    model = _seeded_dit(dev).eval()
    enc = np.random.default_rng(2).standard_normal((4, 512)) \
        .astype(np.float32)
    svc = SynthesisService(SynthesisEngine(
        model, make_schedule(device=dev), image_size=16, wave_size=8,
        ragged=True), key=3, store=SynthesisStore(tmp_path / "store"))
    futs = [svc.submit(e, i, 5, guidance=2.0, num_steps=4)
            for i, e in enumerate(enc)]
    rows = torch.cat(svc.gather(futs))
    assert svc.stats["waves"] == 3 and rows.device.type == "cuda"
    torch.save(model.state_dict(), tmp_path / "dit.pt")
    np.save(tmp_path / "enc.npy", enc)
    src = Path(__file__).resolve().parents[1] / "src"
    child = subprocess.run(
        [sys.executable, "-c", _STORE_CHILD, str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(src)})
    assert child.returncode == 0, child.stderr
    sha, launches, waves, hits = child.stdout.split()
    assert sha == hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
    assert (int(launches), int(waves), int(hits)) == (0, 0, 20)


def test_streaming_is_snapshot_bit_for_bit_on_the_card(dev):
    """Ragged requests streamed in through ``poll`` at wave boundaries give
    the rows a snapshot drain of the same requests gives, bit for bit:
    rows are keyed by identity and the arrivals fill the same waves."""
    from repro_torch.serve import SynthesisEngine, SynthesisService
    model = _seeded_dit(dev).eval()
    sched = make_schedule(device=dev)
    rng = np.random.default_rng(4)
    subs = [(rng.standard_normal(512).astype(np.float32), i % 3, 4,
             (2.0, 4.0)[i % 2], (4, 2)[i % 3 == 0]) for i in range(8)]

    def service():
        return SynthesisService(SynthesisEngine(
            model, sched, image_size=16, wave_size=8, ragged=True), key=6)

    snap = service()
    want = snap.gather([snap.submit(e, c, n, guidance=g, num_steps=s)
                        for e, c, n, g, s in subs])
    stream, late = service(), list(subs[4:])
    futs = [stream.submit(e, c, n, guidance=g, num_steps=s)
            for e, c, n, g, s in subs[:4]]

    def poll():
        if late:
            e, c, n, g, s = late.pop(0)
            futs.append(stream.submit(e, c, n, guidance=g, num_steps=s))
        return bool(late)

    stream.drain(poll=poll)
    assert all(torch.equal(f.result(), w) for f, w in zip(futs, want))
    assert stream.stats["streamed"] == 4 and stream.stats["waves"] == 4


def _placed_requests(rng_seed=12, n=8):
    """``n`` requests of 6 rows at 25 or 20 steps: rows of 20+ steps are
    gated at 2e-2 across packings (a 4-step row's first step divides by
    √ᾱ_999 and amplifies another batch size's rounding past any fixed
    gate)."""
    rng = np.random.default_rng(rng_seed)
    return [(rng.standard_normal(512).astype(np.float32), i % 3, 6,
             (2.0, 4.0)[i % 2], (25, 20)[i % 3 == 0]) for i in range(n)]


def _placed_drain(model, sched, key, subs, **kw):
    from repro_torch.serve import SynthesisEngine
    eng = SynthesisEngine(model, sched, image_size=16, wave_size=16,
                          ragged=True, **kw)
    rids = [eng.submit(e, c, n, guidance=g, num_steps=s)
            for e, c, n, g, s in subs]
    out = eng.run(key)
    return torch.cat([out[r] for r in rids]), eng


def test_placed_windows_run_on_their_hosts_streams(dev, monkeypatch):
    """With ``workers=True`` each host's windows launch on a CUDA stream of
    the host's own (not the drain thread's), every window is fenced on its
    own event, and the D_syn equals the ``workers=False`` drain's (every
    window on the drain thread's stream) bit for bit."""
    from repro_torch.serve import synthesis as synth
    model = _seeded_dit(dev).eval()
    sched = make_schedule(device=dev)
    streams, events = {}, []
    real_seg, real_fence = synth._window_segment, synth.SynthesisEngine._fence

    def seg(*args, **kwargs):
        streams.setdefault(kwargs["row_offset"] // 8, set()).add(
            torch.cuda.current_stream().cuda_stream)
        return real_seg(*args, **kwargs)

    def fence(self, done, **kw):
        if isinstance(done, synth._WindowOut):
            events.extend(e for _, e in done.chunks)
        return real_fence(self, done, **kw)

    monkeypatch.setattr(synth, "_window_segment", seg)
    monkeypatch.setattr(synth.SynthesisEngine, "_fence", fence)
    subs, key = _placed_requests(), prng.PRNGKey(12)
    on, eng = _placed_drain(model, sched, key, subs, hosts=2)
    default = torch.cuda.default_stream().cuda_stream
    assert sorted(streams) == [0, 1]
    on_streams = set().union(*streams.values())
    assert default not in on_streams and len(on_streams) == 2
    assert all(len(s) == 1 for s in streams.values())
    assert len(events) == 2 * eng.stats["waves"]
    assert all(e is not None and e.query() for e in events)
    streams.clear()
    off, _ = _placed_drain(model, sched, key, subs, hosts=2, workers=False)
    assert set().union(*streams.values()) == {
        torch.cuda.current_stream().cuda_stream}
    assert torch.equal(on, off)


def test_launch_counters_lose_no_count_under_eight_threads(dev):
    """Eight threads launching at once: every launch counted, and the
    per-row wrappers' launches at a non-zero ``row_offset`` counted apart."""
    import threading
    x, sc, sh = _randn(dev, 30, (4, 17, 144), (4, 144), (4, 144))
    xs = _randn(dev, 31, (8, 4, 4, 3), (8, 4, 4, 3), (8, 4, 4, 3),
                (8, 4, 4, 3))
    s, ab_t, ab_prev, act = _rowwise_table(16)
    n = 200
    an0, rw0 = an_ops.adaln_norm.launches, cfg_ops.cfg_update_rowwise.launches
    off0 = cfg_ops.cfg_update_rowwise.launches_offset
    go = threading.Barrier(8)

    def work():
        go.wait()
        for i in range(n):
            an_ops.adaln_norm(x, sc, sh)
            cfg_ops.cfg_update_rowwise(*xs[:3], s, ab_t, ab_prev, xs[3], act,
                                       row_offset=8 * (i % 2))
        torch.cuda.synchronize()

    with torch.inference_mode():
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert an_ops.adaln_norm.launches - an0 == 8 * n
    assert cfg_ops.cfg_update_rowwise.launches - rw0 == 8 * n
    assert cfg_ops.cfg_update_rowwise.launches_offset - off0 == 8 * n // 2


_FAILOVER_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from test_torch_cuda import _placed_drain, _placed_requests, _seeded_dit
from repro_torch import prng
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.serve import FaultInjector
dev = torch.device("cuda")
model = _seeded_dit(dev).eval()
sched = make_schedule(device=dev)
subs, key = _placed_requests(13, 12), prng.PRNGKey(13)
outs = []
for workers in (True, True, False):
    x, eng = _placed_drain(model, sched, key, subs, hosts=4, workers=workers,
                           faults=FaultInjector([("window", 3, 0),
                                                 ("window", 1, 2)]))
    assert eng.topology.failed == {1, 3}, eng.topology.failed
    outs.append(x)
healthy, _ = _placed_drain(model, sched, key, subs, hosts=4)
print(int(torch.equal(outs[0], outs[1])), int(torch.equal(outs[0], outs[2])),
      float((outs[0] - healthy).abs().max()))
"""


def test_failover_discarding_launched_windows_leaves_no_hazard(dev):
    """Hosts 3 and 1 lost at waves 0 and 2 of an H = 4 drain, in a child
    process with ``CUDA_LAUNCH_BLOCKING=0``: each aborted wave launches
    none of its windows (every host's fault site is checked first) while
    the wave before it is still in flight on the hosts' streams and is
    retired, and the drain replays bit for bit, equals the
    ``workers=False`` drill, and stays within the 20+-step gate (2e-2) of
    the healthy drain."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    src = tests.parent / "src"
    child = subprocess.run(
        [sys.executable, "-c", _FAILOVER_CHILD, str(tests)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_LAUNCH_BLOCKING": "0",
             "PYTHONPATH": str(src)})
    assert child.returncode == 0, child.stderr
    replay, off, err = child.stdout.split()
    assert (replay, off) == ("1", "1")
    assert float(err) <= 2e-2


# -- slice 14: the DiT's bf16_act path, MoE FFNs --------------------------------

def test_bf16_act_kernel_path_holds_the_reference_gate(dev):
    """The paper preset's DiT (4 layers, 4 heads of 36, 16 px, batch 64)
    with ``bf16_act`` on the kernel path (its four GEMMs a block on the
    tensor cores, bf16 operands into fp32) against the plain fp32 path,
    at the reference's own bf16 gate (``tests/test_dit_fused.py``):
    max|Δ| < 2e-2·max(max|y|, 1).  The GEMMs are counted; attention stays
    on the short fp32 kernel."""
    from repro_torch.diffusion import dit as dit_mod
    dc = DiffusionConfig(d_model=144, num_layers=4, num_heads=4)
    model = init_dit(prng.PRNGKey(0), dc, 16, 3, device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 60 + i, p.shape)[0])
    plain = copy.deepcopy(model)
    plain.plain = True
    model.dc = dataclasses.replace(dc, bf16_act=True)
    x, y = _randn(dev, 61, (64, 16, 16, 3), (64, 512))
    t = torch.arange(64, device=dev) * 15
    calls, short = (dit_mod.bf16_dense.calls,
                    fa_ops.flash_attention.launches_short)
    with torch.inference_mode():
        out = model(x, t, y)
        ref = plain(x, t, y)
    assert dit_mod.bf16_dense.calls - calls == 4 * dc.num_layers
    assert fa_ops.flash_attention.launches_short - short == dc.num_layers
    scale = max(float(ref.abs().max()), 1.0)
    err = _err(out, ref)
    assert out.dtype == torch.float32 and float(ref.abs().max()) > 1e-2
    assert 0 < err < 2e-2 * scale, err


@pytest.mark.parametrize("name,layer", [("jamba-1.5-large-398b", 0),
                                        ("xlstm-125m", 0),
                                        ("xlstm-125m", 1)])
def test_recurrent_mixer_on_the_card_matches_the_cpu(dev, name, layer):
    """A Mamba, an mLSTM and an sLSTM mixer of ``init_lm``'s smoke weights in
    fp32: a 2 × 32 forward (chunk 8, so the state crosses chunk
    boundaries) with its final state, then 4 decode steps from it, card
    against CPU, each output and state leaf within 1e-4 of its size (fp32
    sums in another order; the sLSTM carries them along the sequence)."""
    from repro_torch.configs import shapes
    from repro_torch.models.transformer import RECURRENT
    cfg = shapes.smoke_config(get_config(name))
    kind = cfg.layer_kind(layer)
    _, forward, decode, _ = RECURRENT[kind]
    mixer = init_lm(prng.PRNGKey(6), cfg, device="cpu").layers[layer].mixer
    x = 0.5 * torch.randn((2, 36, cfg.d_model),
                          generator=torch.Generator().manual_seed(6))
    kw = {} if kind == "slstm" else {"chunk": 8}
    outs = []
    for d in ("cpu", dev):
        m = copy.deepcopy(mixer).to(d)
        with torch.inference_mode():
            y, state = forward(m, cfg, x[:, :32].to(d), return_state=True,
                               **kw)
            got = [y, *state]
            for t in range(32, 36):
                y, state = decode(m, cfg, x[:, t:t + 1].to(d), state)
                got += [y, *state]
        outs.append([t.float().cpu() for t in got])
    for a, b in zip(*outs):
        assert _err(b, a) <= 1e-4 * max(1.0, float(a.abs().max()))
    assert float(outs[0][0].abs().max()) > 1e-2


def _moe_smoke(dev, dtype="bfloat16"):
    from repro_torch.configs import shapes
    return shapes.smoke_config(get_config("olmoe-1b-7b")).replace(
        dtype=dtype)


def test_moe_layer_on_the_card_matches_the_cpu(dev):
    """An olmoe-smoke MoE layer in bf16 (4 experts top-2, d 256) on 64
    tokens, card against CPU on the same weights and inputs: the same
    experts for every token, and the output within two bf16 ulps of its
    largest value (each expert GEMM and combine add rounds to bf16; the two
    devices sum in another order)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_lm
    cfg = _moe_smoke(dev)
    mod = init_lm(prng.PRNGKey(3), cfg, device="cpu").layers[0].moe
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3)).bfloat16()
    outs, idxs = [], []
    for d in ("cpu", dev):
        m = copy.deepcopy(mod).to(d)
        with torch.inference_mode():
            out, aux = moe_mod.moe_apply(m, cfg, x.to(d))
            idxs.append(moe_mod.route(m.w_router, x.to(d).reshape(
                -1, cfg.d_model), cfg.moe)[1].cpu())
        outs.append((out.float().cpu(), float(aux)))
    assert torch.equal(idxs[0], idxs[1])
    scale = float(outs[0][0].abs().max())
    assert _err(outs[1][0], outs[0][0]) <= 2.0 ** -6 * scale
    assert abs(outs[0][1] - outs[1][1]) < 1e-5


def test_olmoe_smoke_prefill_on_the_card_matches_the_cpu(dev):
    """olmoe-smoke in bf16 on ``init_lm``'s CPU weights: a 2 × 40 prefill
    on the card (flash attention on the tensor cores) against the CPU's
    plain route.  Every (token, layer) picks the same experts, except
    where the CPU's router logits at the top-2 boundary lie within two
    bf16 ulps of each other (a rounding the card may take otherwise: 4 of
    the 160 pairs on the CPU, most of them exact ties; the count is
    printed); the
    last-position logits agree to 2^-4 of their largest value (bf16
    residuals through two layers)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_lm
    cfg = _moe_smoke(dev)
    lm = init_lm(prng.PRNGKey(4), cfg, device="cpu").eval()
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 40)))
    route = moe_mod.route
    seen = []

    def recorded(w, x_flat, m):
        out = route(w, x_flat, m)
        seen.append((out[1].cpu(), (x_flat @ w.to(x_flat.dtype)).float()
                     .cpu()))
        return out

    moe_mod.route = recorded
    try:
        last = {}
        for d in ("cpu", dev):
            m = copy.deepcopy(lm).to(d)
            before = fa_ops.flash_attention.launches_tensor_core
            with torch.inference_mode():
                last[d] = m(toks.to(d), Parallel(prefill_last_only=True),
                            mode="prefill")[0][:, -1].float().cpu()
            if d != "cpu":
                assert (fa_ops.flash_attention.launches_tensor_core - before
                        == cfg.num_layers)
    finally:
        moe_mod.route = route
    assert len(seen) == 2 * cfg.num_layers
    near = 0
    for (cpu_idx, cpu_logits), (card_idx, _) in zip(seen[:2], seen[2:]):
        differ = (cpu_idx.sort(-1).values != card_idx.sort(-1).values
                  ).any(-1)
        top = cpu_logits.sort(-1, descending=True).values
        k = cfg.moe.top_k
        gap = top[:, k - 1] - top[:, k]
        close = gap <= 2 * 2.0 ** -7 * top[:, k - 1].abs()
        near += int(close.sum())
        assert not bool((differ & ~close).any())
    print(f"olmoe-smoke prefill: {near} (token, layer) pairs within two "
          f"bf16 ulps at the top-2 boundary")
    scale = float(last["cpu"].abs().max())
    assert scale > 1e-2
    assert _err(last[dev], last["cpu"]) <= 2.0 ** -4 * scale


def test_stable_top_k_on_the_card_breaks_ties_lower_first(dev):
    """bf16 router logits that tie three ways at the top-2 boundary on
    every token (experts 3, 5 and 6 share a column): the card picks expert
    3 second, as ``jax.lax.top_k`` does, and ranks all eight experts as the
    CPU does."""
    from repro_torch.models import moe as moe_mod
    cfg = _moe_smoke(dev).replace(
        moe=dataclasses.replace(_moe_smoke(dev).moe, num_experts=8))
    g = torch.Generator().manual_seed(7)
    x = torch.randn((48, 64), generator=g).abs()
    u = torch.randn((64,), generator=g).abs() / 64
    w = u[:, None] * torch.tensor([3, 1, 0.5, 2, -1, 2, 2, 1.5])[None]
    got = {}
    for d in ("cpu", dev):
        xb = x.to(d).bfloat16()
        logits = (xb @ w.to(d).bfloat16()).float()
        assert torch.equal(logits[:, 3], logits[:, 5])
        gates, idx, _ = moe_mod.route(w.to(d), xb, cfg.moe)
        got[d] = (idx.cpu(), gates.cpu(),
                  moe_mod.top_k_lower_first(logits, 8)[1].cpu())
    assert got[dev][0][:, 1].tolist() == [3] * 48
    assert torch.equal(got[dev][0], got["cpu"][0])
    assert torch.equal(got[dev][2], got["cpu"][2])
    assert _err(got[dev][1], got["cpu"][1]) < 1e-6


# -- slice 16: the frontends, the encoder head and LM training ------------------

def _frontend_batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "mask": rng.random((B, S)) < 0.3,
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)}
    P = cfg.num_prefix_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S - P)).astype(np.int32)}
    if P:
        batch["patches"] = rng.standard_normal(
            (B, P, cfg.frontend_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", ["hubert-xlarge", "internvl2-1b",
                                  "olmoe-1b-7b"])
def test_train_steps_on_the_card_match_the_cpu(dev, name):
    """Three ``make_train_step`` steps of the smoke config on the card and
    on the CPU from one set of fp32 weights (``init_train_state``'s CPU
    draw): the loss, ``ce``, ``aux`` and gradient norm within 1e-5
    relative, each parameter within 1e-5 of its leaf's largest element
    plus ``adamw_update_bound`` of the CPU's moments (AdamW normalises a
    gradient that is rounding noise to ~lr on either device); no kernel
    launched (training runs the plain route)."""
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.models.transformer import LM
    from repro_torch.optim.optimizers import adamw_update_bound, init_adamw
    from repro_torch.train.steps import (TrainState, init_train_state,
                                         make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(get_config(name))
    cpu = init_train_state(prng.PRNGKey(8), cfg, device="cpu")
    lm = LM(cfg, device=dev, param_dtype=torch.float32)
    lm.load_state_dict(cpu.params.state_dict())
    card = TrainState(lm, init_adamw({k: v.detach() for k, v in
                                      lm.named_parameters()}))
    step = make_train_step(cfg)
    before = fa_ops.flash_attention.launches
    drift = {k: 0.0 for k in cpu.opt.mu}
    for i in range(3):
        batch = _frontend_batch(cfg, 30 + i)
        prev = cpu.opt
        cpu, m_cpu = step(cpu, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        card, m_card = step(card, {k: torch.as_tensor(v, device=dev)
                                   for k, v in batch.items()})
        for k in ("loss", "ce", "aux", "grad_norm"):
            a, b = float(m_card[k]), float(m_cpu[k])
            assert abs(a - b) <= 1e-5 * max(abs(b), 1.0), (k, a, b)
        bound = adamw_update_bound(prev, cpu.opt, lr=3e-4, rel=1e-5)
        want, got = cpu.params.state_dict(), card.params.state_dict()
        for k, w in want.items():
            drift[k] = drift[k] + bound[k]
            err = (got[k].cpu() - w).abs()
            assert bool((err <= 1e-5 * w.abs().max() + drift[k]).all()), \
                (i, k, float(err.max()))
    assert fa_ops.flash_attention.launches == before
    assert math.isfinite(float(m_card["loss"]))


def test_bf16_train_steps_on_the_card_run_the_plain_route(dev):
    """internvl-smoke with bf16 activations and fp32 master weights: three
    steps on the card run (the plain attention's contractions on fp32
    copies while a gradient flows: ``bmm`` with an fp32 output has no
    derivative), launch no kernel, keep the weights fp32, and their losses
    agree with the fp32-activation run's to bf16's rounding."""
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg32 = smoke_config(get_config("internvl2-1b"))
    losses = {}
    before = fa_ops.flash_attention.launches
    for dtype in ("bfloat16", "float32"):
        cfg = cfg32.replace(dtype=dtype)
        state = init_train_state(prng.PRNGKey(4), cfg, device=dev)
        step = make_train_step(cfg)
        out = []
        for i in range(3):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in _frontend_batch(cfg, 50 + i).items()}
            state, m = step(state, batch)
            out.append(float(m["loss"]))
        assert all(p.dtype == torch.float32
                   for p in state.params.parameters())
        losses[dtype] = out
    assert fa_ops.flash_attention.launches == before
    assert all(math.isfinite(x) for x in losses["bfloat16"])
    assert max(abs(a - b) for a, b in zip(*losses.values())) < 5e-2


def test_frontend_prefill_takes_the_tensor_core_kernel(dev):
    """bf16 prefills of hubert-smoke (non-causal frames) and internvl-smoke
    (patches then text, GQA 4/2) each launch the tensor-core kernel once a
    layer, and the kernel route's logits agree with the plain route's in
    fp32 on the same weights (2e-5 at smoke size)."""
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.models.transformer import LM
    fa = fa_ops.flash_attention
    for name in ("hubert-xlarge", "internvl2-1b"):
        cfg32 = smoke_config(get_config(name))
        cfg = cfg32.replace(dtype="bfloat16")
        lm32 = init_lm(prng.PRNGKey(9), cfg32, device=dev).eval()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in _frontend_batch(cfg, 40, S=40).items()}
        with torch.inference_mode():
            got = lm32(batch, Parallel(use_kernels=True))[0]
            want = lm32(batch, Parallel(use_kernels=False))[0]
        assert _err(got, want) <= 2e-5 * max(1.0, float(want.abs().max()))
        lm = LM(cfg, device=dev)
        lm.load_state_dict(lm32.state_dict())
        before = (fa.launches, fa.launches_tensor_core)
        with torch.inference_mode():
            out = lm.eval()(batch, Parallel(prefill_last_only=True),
                            mode="prefill")[0]
        assert (fa.launches - before[0], fa.launches_tensor_core
                - before[1]) == (cfg.num_layers, cfg.num_layers)
        assert bool(torch.isfinite(out).all())


def test_moe_ep_on_the_card_matches_the_cpu(dev):
    """olmoe-smoke's MoE layer in fp32 through ``moe_ep`` on a 1×1 mesh of
    the card against a 1×1 mesh of the CPU, at capacity factor 1.25 on 4 ×
    32 positive tokens with the router leaning to expert 0 (so experts
    drop pairs): the output within 1e-5 of its largest value, aux within
    1e-6, the same dropped-pair count, and x's gradient within 1e-5 of its
    largest element."""
    from repro_torch.configs import shapes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = shapes.smoke_config(get_config("olmoe-1b-7b"))
    mod = init_lm(prng.PRNGKey(4), cfg, device="cpu").layers[0].moe
    with torch.no_grad():
        mod.w_router[:, 0] += 0.003
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4)).abs() + 0.5
    outs = []
    moe_mod.moe_ep.record = []
    try:
        for d in ("cpu", dev):
            par = Parallel(model_axis="model", data_axes=("data",),
                           mesh=make_host_mesh(1, 1, device=d),
                           use_kernels=False)
            xd = x.to(d, copy=True).requires_grad_()
            out, aux = moe_mod.moe_apply(copy.deepcopy(mod).to(d), cfg, xd,
                                         par)
            (out.square().sum() + aux).backward()
            outs.append((out.detach().cpu(), float(aux.detach()),
                         xd.grad.cpu()))
        drops = [int(n) for n in moe_mod.moe_ep.record]
    finally:
        moe_mod.moe_ep.record = None
    assert drops[0] == drops[1] > 0
    (y0, a0, g0), (y1, a1, g1) = outs
    assert _err(y1, y0) <= 1e-5 * float(y0.abs().max())
    assert abs(a0 - a1) <= 1e-6
    assert _err(g1, g0) <= 1e-5 * float(g0.abs().max())


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "xlstm-125m"])
def test_launcher_on_the_card_matches_the_cpu(dev, name):
    """``launch/train.py``'s run of the smoke config, 2 steps of 2 × 16 on
    a 1×1 mesh, on the card and on the CPU: the losses within 1e-5
    relative, olmoe's MoE layers on ``moe_ep`` on both, no kernel
    launched."""
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.launch.train import train
    from repro_torch.models import moe as moe_mod
    cfg = smoke_config(get_config(name))
    before, calls = fa_ops.flash_attention.launches, moe_mod.moe_ep.calls
    runs = [train(cfg, steps=2, batch=2, seq=16, device=d,
                  log=lambda *a: None) for d in ("cpu", dev)]
    for a, b in zip(runs[1]["losses"], runs[0]["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    want = 2 * 2 * cfg.num_layers if cfg.moe else 0
    assert moe_mod.moe_ep.calls - calls == want
    assert fa_ops.flash_attention.launches == before


# -- the MoE's compact expert pass (kernels/moe) ---------------------------------

def _moe_layout(dev, T, E, k, cap, seed, skew=0.0):
    """Random router choices for T tokens over E experts (expert 0 leaning
    by ``skew``) and their compact layout."""
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(dev).manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device=dev)
    logits[:, 0] += skew
    vals, idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                           descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    idx = idx[:, :k]
    return gates, idx, moe_mod.compact_dispatch(gates, idx, E, cap)


def _moe_weights(dev, E, d, fe, seed):
    g = torch.Generator(dev).manual_seed(seed)
    draw = lambda *s: (torch.randn(s, generator=g, device=dev,
                                   dtype=torch.bfloat16) / s[-2] ** 0.5)
    return draw(E, d, fe), draw(E, d, fe), draw(E, fe, d)


def _live_rows(c):
    from repro_torch.kernels.moe.kernel import BM
    return int(c.tile_start[-1]) * BM


@pytest.mark.parametrize("T,E,k,d,fe", [
    (32768, 64, 8, 2048, 1024),    # olmoe's prefill wave
    (2048, 64, 8, 2048, 1024),     # olmoe, 8d's wave A
    (256, 8, 2, 8192, 24576),      # jamba-1.5-large's experts
    (64, 64, 8, 2048, 1024),       # olmoe decode, B 64
    (8, 64, 8, 2048, 1024),        # olmoe decode, B 8
    (300, 6, 2, 256, 520),         # N not a tile's multiple
])
def test_moe_grouped_kernels_match_plain(dev, T, E, k, d, fe):
    """The up/gate and down kernels against their plain versions on the
    compact layout of a random routing (capacity 4× the mean): every live
    row within two bf16 ulps of the largest value (the card's own bf16
    matmuls sum in another order), the combine bit for bit against the
    plain combine on the kernel's rows, and one launch each."""
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.kernels.moe import ref as moe_ref
    cap = max(1, -(-T * k // E) * 4)
    gates, idx, c = _moe_layout(dev, T, E, k, cap, seed=T + E)
    up, gate, down = _moe_weights(dev, E, d, fe, seed=d + fe)
    x = torch.randn((T, d), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).bfloat16()
    n = _live_rows(c)
    before = (moe_ops.expert_up.launches, moe_ops.expert_down.launches,
              moe_ops.combine.launches)
    with torch.inference_mode():
        h = moe_ops.expert_up(x, c.rows, c.tile_start, up, gate, "silu",
                              c.group_div, c.tiles_max)
        h_ref = moe_ref.expert_up(x, c.rows, c.tile_start, up, gate, "silu",
                                  c.group_div, c.tiles_max)
        y = moe_ops.expert_down(h, c.tile_start, down, c.group_div,
                                c.tiles_max)
        y_ref = moe_ref.expert_down(h, c.tile_start, down, c.group_div,
                                    c.tiles_max)
        out = moe_ops.combine(y, c.pair_rows, c.pair_gates)
        out_ref = moe_ref.combine(y, c.pair_rows, c.pair_gates)
        torch.cuda.synchronize()
    for got, want in ((h, h_ref), (y, y_ref)):
        scale = float(want[:n].float().abs().max())
        assert scale > 1e-3
        assert _err(got[:n].float(), want[:n].float()) <= 2.0 ** -6 * scale
    assert torch.equal(out, out_ref)
    assert (moe_ops.expert_up.launches, moe_ops.expert_down.launches,
            moe_ops.combine.launches) == tuple(b + 1 for b in before)


def test_moe_grouped_kernels_take_empty_and_ragged_groups(dev):
    """Top-1 routing by hand: groups of 0, 1, 127, 128, 129, 300, 57 and 3
    rows (none a multiple of the tile but one) with capacity 200, so the
    300-row group drops 100: 9 row tiles; the kernels against their plain
    versions on every live row, the pad rows zero."""
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.kernels.moe import ref as moe_ref
    from repro_torch.models import moe as moe_mod
    sizes = [0, 1, 127, 128, 129, 300, 0, 57, 3]
    E, d, fe = len(sizes), 256, 512
    idx = torch.cat([torch.full((s,), e) for e, s in enumerate(sizes)])
    idx = idx[torch.randperm(idx.numel(),
                             generator=torch.Generator().manual_seed(5))]
    idx = idx.to(dev)[:, None]
    gates = torch.ones(idx.shape, device=dev)
    c = moe_mod.compact_dispatch(gates, idx, E, 200)
    kept = [min(s, 200) for s in sizes]
    assert int(c.counts()["dropped"]) == 100
    assert c.tile_start.tolist() == [0] + list(np.cumsum(
        [-(-s // 128) for s in kept]))
    up, gate, down = _moe_weights(dev, E, d, fe, seed=6)
    x = torch.randn((idx.shape[0], d), generator=torch.Generator(dev)
                    .manual_seed(6), device=dev).bfloat16()
    with torch.inference_mode():
        h = moe_ops.expert_up(x, c.rows, c.tile_start, up, gate, "silu",
                              c.group_div, c.tiles_max)
        y = moe_ops.expert_down(h, c.tile_start, down, c.group_div,
                                c.tiles_max)
        y_ref = moe_ref.expert_down(
            moe_ref.expert_up(x, c.rows, c.tile_start, up, gate, "silu",
                              c.group_div, c.tiles_max),
            c.tile_start, down, c.group_div, c.tiles_max)
    n = _live_rows(c)
    scale = float(y_ref[:n].float().abs().max())
    assert _err(y[:n].float(), y_ref[:n].float()) <= 2.0 ** -6 * scale
    pad = (c.rows[:n] < 0)
    assert int(pad.sum()) == n - sum(kept)
    assert not bool(y[:n][pad].any())


def test_moe_grouped_kernel_rows_do_not_depend_on_their_group(dev):
    """A row's output bits depend only on that row and its expert: the
    same 300 tokens laid out in two groups of one expert in one order, then
    shuffled among 200 other tokens' rows in another, give each token the
    same bits in both layouts."""
    from repro_torch.kernels.moe import ops as moe_ops
    d, fe, E = 2048, 1024, 4
    up, gate, down = _moe_weights(dev, E, d, fe, seed=8)
    x = torch.randn((500, d), generator=torch.Generator(dev).manual_seed(8),
                    device=dev).bfloat16()

    def run(groups, expert_of_group):
        """groups: token lists; group g on expert expert_of_group[g] (one
        group per expert slot, group_div 1, empty groups between)."""
        per = [[] for _ in range(E)]
        for g, toks in zip(expert_of_group, groups):
            per[g] = toks
        tiles = [-(-len(t) // 128) for t in per]
        tile_start = torch.tensor([0] + list(np.cumsum(tiles)),
                                  dtype=torch.int32, device=dev)
        tmax = int(sum(tiles)) + 1
        rows = torch.full((tmax * 128,), -1, dtype=torch.int32)
        where = {}
        for e, toks in enumerate(per):
            base = int(tile_start[e]) * 128
            rows[base:base + len(toks)] = torch.tensor(toks,
                                                       dtype=torch.int32)
            where.update({t: base + i for i, t in enumerate(toks)})
        with torch.inference_mode():
            h = moe_ops.expert_up(x, rows.to(dev), tile_start, up, gate,
                                  "silu", 1, tmax)
            y = moe_ops.expert_down(h, tile_start, down, 1, tmax)
        return y, where

    y_a, at_a = run([list(range(300))], [2])
    mixed = torch.randperm(500, generator=torch.Generator()
                           .manual_seed(9)).tolist()
    y_b, at_b = run([mixed[:250], mixed[250:]], [2, 0])
    both = [t for t in mixed[:250] if t < 300]        # on expert 2 twice
    assert len(both) > 100
    assert any(at_a[t] % 128 != at_b[t] % 128 for t in both)
    for t in both:
        assert torch.equal(y_a[at_a[t]], y_b[at_b[t]])


def test_compact_dispatch_on_the_card_keeps_the_padded_drop_set(dev):
    """``compact_dispatch`` on the card against ``models/moe.py::dispatch``
    on the card, olmoe's prefill wave with the router leaning to expert 0
    (so it drops): the same kept (token, expert) pairs at the same ranks,
    the same drop count."""
    from repro_torch.models import moe as moe_mod
    T, E, k = 32768, 64, 8
    cap = 4 * -(-T * k // E)
    gates, idx, c = _moe_layout(dev, T, E, k, cap, seed=11, skew=2.5)
    tok, wgt, slot = moe_mod.dispatch(gates, idx, E, cap)
    n = tok.numel()
    kept = slot < n                                      # (T, E)
    assert int(c.counts()["dropped"]) == int((gates > 0).sum()
                                             - kept.sum()) > 0
    # every kept pair: padded slot e·cap + rank against compact row
    pair_e = torch.sort(idx, -1).values                  # the combine's order
    rows = c.pair_rows.long()
    pslot = slot.gather(1, pair_e)
    assert torch.equal(rows >= 0, pslot < n)
    ts = c.tile_start.long()
    e_of = pair_e[rows >= 0]
    assert torch.equal(rows[rows >= 0] - ts[e_of] * 128,
                       pslot[rows >= 0] - e_of * cap)


def test_moe_compact_pass_matches_the_padded_pass_and_makes_no_sync(dev):
    """olmoe's MoE layer at full width in bf16 on a 4 × 512 wave: the
    compact pass (taken by ``moe_dense`` under inference mode, no host
    sync: ``set_sync_debug_mode("error")``) against the padded pass on the
    same routing within two bf16 ulps of the largest value; one launch of
    each kernel; the tracer's ``moe.experts`` span says ``compact``."""
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.obs.trace import Tracer, using
    cfg = get_config("olmoe-1b-7b")
    layer = moe_mod.MoE(cfg, device=dev, dtype=torch.bfloat16)
    g = torch.Generator(dev).manual_seed(12)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev)
                    / p.shape[-2] ** 0.5)
    x = torch.randn((4, 512, cfg.d_model), generator=g,
                    device=dev).bfloat16()
    before = moe_ops.expert_up.launches
    tr = Tracer(enabled=True)
    with torch.inference_mode(), using(tr):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = moe_mod.moe_dense(layer, cfg, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        flat = x.reshape(-1, cfg.d_model)
        gates, idx, _ = moe_mod.route(layer.w_router, flat, cfg.moe)
        cap = moe_mod.capacity(flat.shape[0], cfg.moe)
        want = moe_mod.padded_pass(layer, cfg, flat, 0, 64, cap, gates, idx)
    assert moe_ops.expert_up.launches == before + 1
    paths = [s.attrs["path"] for s in tr.spans if s.name == "moe.experts"]
    assert paths == ["compact", "padded"]
    scale = float(want.float().abs().max())
    assert _err(out.reshape(want.shape).float(), want.float()) \
        <= 2.0 ** -6 * scale


def test_moe_ep_equals_moe_dense_bit_for_bit_on_the_compact_path(dev):
    """olmoe-smoke's MoE layer in bf16 under inference mode: ``moe_ep`` on
    a 1×1 mesh of the card at capacity factor 8 and ``moe_dense`` (neither
    drops) give the same bits, both on the compact path; the training
    path (autograd recording) and fp32 stay padded."""
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    cfg = _moe_smoke(dev)
    wide = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    layer = init_lm(prng.PRNGKey(13), cfg, device="cpu").layers[0].moe
    layer = copy.deepcopy(layer).to(dev, torch.bfloat16)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(dev)
                    .manual_seed(13), device=dev).bfloat16()
    par = Parallel(model_axis="model", data_axes=("data",),
                   mesh=make_host_mesh(1, 1, device=dev))
    before = moe_ops.expert_up.launches
    with torch.inference_mode():
        y_ep, _ = moe_mod.moe_apply(layer, wide, x, par)
        y_dn, _ = moe_mod.moe_dense(layer, cfg, x)
    assert moe_ops.expert_up.launches == before + 2
    assert torch.equal(y_ep, y_dn)
    flat = x.reshape(-1, cfg.d_model)
    with torch.no_grad():
        assert moe_mod.compact_route(layer, flat)
        assert not moe_mod.compact_route(layer, flat.float())
        assert not moe_mod.compact_route(layer, flat.cpu())
    assert not moe_mod.compact_route(layer, flat)   # the weights need grads


def test_moe_kernels_refuse_what_they_do_not_take(dev):
    """The wrappers raise on fp32 rows, weights off the card, a width that
    is not whole 16-byte chunks, mismatched widths, int64 index vectors,
    an activation other than silu, experts without a gate and a combine
    of more than 8 experts a token."""
    from repro_torch.kernels.moe import ops as moe_ops
    E, d, fe, T = 4, 256, 512, 64
    gates, idx, c = _moe_layout(dev, T, E, 2, 64, seed=14)
    up, gate, down = _moe_weights(dev, E, d, fe, seed=14)
    x = torch.randn((T, d), device=dev).bfloat16()
    args = (c.rows, c.tile_start)
    tail = (c.group_div, c.tiles_max)
    with pytest.raises(NotImplementedError):
        moe_ops.expert_up(x.float(), *args, up.float(), gate.float(), "silu",
                          *tail)
    with pytest.raises(ValueError):
        moe_ops.expert_up(x, *args, up.cpu(), gate.cpu(), "silu", *tail)
    with pytest.raises(ValueError):
        moe_ops.expert_up(x[:, :250], *args, up[:, :250], gate[:, :250],
                          "silu", *tail)
    with pytest.raises(ValueError):
        moe_ops.expert_up(x[:, :128], *args, up, gate, "silu", *tail)
    with pytest.raises(ValueError):
        moe_ops.expert_up(x, c.rows.long(), c.tile_start, up, gate, "silu",
                          *tail)
    with pytest.raises(NotImplementedError):
        moe_ops.expert_up(x, *args, up, gate, "gelu", *tail)
    with pytest.raises(NotImplementedError):
        moe_ops.expert_up(x, *args, up, None, "silu", *tail)
    h = torch.zeros((c.tiles_max * 128, fe), device=dev,
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        moe_ops.expert_down(h, c.tile_start.long(), down, *tail)
    y = torch.zeros((128, d), device=dev, dtype=torch.bfloat16)
    rows = torch.zeros((T, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        moe_ops.combine(y, rows, torch.ones(rows.shape, device=dev))
    with pytest.raises(NotImplementedError):
        moe_ops.combine(y.float(), rows[:, :2],
                        torch.ones((T, 2), device=dev))
