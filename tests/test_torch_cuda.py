"""The port's hand-written kernels against their plain PyTorch versions on
a CUDA card, and the kernel paths of the sampler and of the LM serving
engine against their plain paths.

Every test here is marked ``cuda`` and skips (deciding inside the test)
where there is no card.  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.diffusion.dit import DiT
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
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine

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
@pytest.mark.parametrize("Hkv,hd", [(8, 64), (4, 128), (1, 256), (4, 256)])
def test_attention_tensor_core_kernel_grid(dev, mode, S, Hkv, hd):
    """The tensor-core kernel against the plain version at lengths of 1,
    one 64-key tile and one key either side of it, a ragged 100 and 129
    (one past the 128-row query tile) and gemma2's 4608; windows on (64)
    and off (65) a key-tile boundary and gemma2's 4096; GQA 8/8, 8/4 and
    8/1; head dims 64, 128 and 256.  Length 1 at head dim 64 is the
    short-sequence kernel's call, within the same gates."""
    causal, window, softcap, q_scale = TC_MODES[mode]
    q, k, v = _tc_inputs(dev, 21, 1 if S > 1000 else 2, S, S, 8, Hkv, hd,
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
    """A 2-layer gemma2 at full width in fp32 on seeded weights: the same
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
    lm = LM(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
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
    model = DiT(dc, 16, 3, generator=torch.Generator(dev).manual_seed(0),
                device=dev)
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
    model = DiT(dc, 16, 3, generator=torch.Generator(dev).manual_seed(0),
                device=dev)
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
    model = DiT(dc, 16, 3, generator=torch.Generator(dev).manual_seed(0),
                device=dev)
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
    clf = classifier_logprob(init_classifier(
        torch.Generator(dev).manual_seed(3), "resnet18", 10, device=dev))
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
    clf = init_classifier(torch.Generator(dev).manual_seed(3), "resnet18", 10,
                          device=dev)
    fn = classifier_logprob(clf)
    (x,) = _randn(dev, 8, (200, 16, 16, 3))
    labels = torch.arange(200, device=dev) % 10
    full = _logprob_grad(fn, x, labels)
    for rows in (slice(0, 5), slice(0, 120), slice(100, 200)):
        assert torch.equal(_logprob_grad(fn, x[rows], labels[rows]),
                           full[rows])


def test_classifier_guided_on_the_card_matches_the_cpu_run(dev):
    """Four classifier-guided steps (a ResNet-18's gradient at each) on the
    card against the same model, classifier, x_T and noise on the CPU, at
    T = 16, the CPU tests' smoke depth and gate."""
    dc = DiffusionConfig(d_model=144, num_layers=2, num_heads=4,
                         train_timesteps=16)
    model = DiT(dc, 16, 3, generator=torch.Generator(dev).manual_seed(0),
                device=dev)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(0.05 * _randn(dev, 10 + i, p.shape)[0])
    clf = init_classifier(torch.Generator(dev).manual_seed(1), "resnet18", 10,
                          device=dev)
    cpu_model, cpu_clf = copy.deepcopy(model).cpu(), copy.deepcopy(clf).cpu()
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn((8, 16, 16, 3), generator=gen)
    noise = torch.randn((4, 8, 16, 16, 3), generator=gen)
    labels = np.arange(8) % 10
    out = sample_classifier_guided(
        model, make_schedule(16, device=dev), classifier_logprob(clf), labels,
        num_steps=4, guidance=1.0, x_T=x_T.to(dev), noise=noise.to(dev))
    ref = sample_classifier_guided(
        cpu_model, make_schedule(16, device="cpu"), classifier_logprob(cpu_clf),
        labels, num_steps=4, guidance=1.0, x_T=x_T, noise=noise)
    assert out.device.type == "cuda" and out.shape == (8, 16, 16, 3)
    assert float(ref.abs().max()) > 1e-3
    assert _err(out.cpu(), ref) < 5e-4
