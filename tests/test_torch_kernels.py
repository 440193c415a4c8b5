"""The port's four kernel families against the JAX package.

On the CPU each wrapper runs its plain version (``ref.py``): it is held
against the reference's jnp oracle and against the Pallas kernel run in
interpret mode, as the reference's own tests run it.  The hand-written
kernels themselves are held against their plain versions on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adaln_norm import ops as j_an_ops
from repro.kernels.adaln_norm import ref as j_an_ref
from repro.kernels.cfg_fuse import ops as j_cfg_ops
from repro.kernels.cfg_fuse import ref as j_cfg_ref
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.kernels.rmsnorm import ops as j_rn_ops
from repro.kernels.rmsnorm import ref as j_rn_ref
from repro_torch.kernels.adaln_norm import ops as an_ops
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


# --- cfg_update -------------------------------------------------------------

@pytest.mark.parametrize("shape,s,ab_t,ab_prev", [
    ((4, 16, 16, 3), 2.0, 0.3, 0.6),
    ((3, 5, 7), 7.5, 0.05, 0.2),             # odd size: no lane multiple
    ((2, 16, 16, 3), 2.0, 2.4288882e-09, 0.24600048),   # t=999 of 4 steps
    ((2, 8, 8, 3), 0.0, 0.9, 1.0),           # last step, σ = 0
])
def test_cfg_update_matches_reference(shape, s, ab_t, ab_prev):
    x, ec, eu, z = _normal(0, shape, shape, shape, shape)
    j = [jnp.asarray(a) for a in (x, ec, eu, z)]
    oracle = j_cfg_ref.cfg_update(j[0], j[1], j[2], s, ab_t, ab_prev, j[3])
    pallas = j_cfg_ops.cfg_update(j[0], j[1], j[2], s, ab_t, ab_prev, j[3],
                                  interpret=True)
    t = [torch.from_numpy(a) for a in (x, ec, eu, z)]
    port = cfg_ops.cfg_update(t[0], t[1], t[2], s, ab_t, ab_prev, t[3])
    assert _max_err(port, oracle) < 1e-5
    assert _max_err(port, pallas) < 1e-5
    step = cfg_ref.ancestral_step(t[0], (1 + s) * t[1] - s * t[2], ab_t,
                                  ab_prev, t[3])
    assert torch.equal(step, port)


def test_cfg_step_scalars_round_like_the_plain_version():
    """The kernel's host-side scalars equal the plain version's fp32
    tensor arithmetic bit for bit, including the cancelling direction
    coefficient of a first step at t = 999."""
    for ab_t, ab_prev in [(2.4288882e-09, 0.24600048), (0.3, 0.6),
                          (0.9, 1.0)]:
        sc = cfg_ops.step_scalars(2.0, ab_t, ab_prev, 1.0)
        a = torch.tensor(ab_t, dtype=torch.float32)
        p = torch.tensor(ab_prev, dtype=torch.float32)
        var = (1.0 - p) / (1.0 - a) * (1.0 - a / p)
        sigma = 1.0 * torch.sqrt(torch.clamp(var, min=0.0))
        dir_coef = torch.sqrt(torch.clamp(1.0 - p - sigma ** 2, min=0.0))
        want = [3.0, 2.0, torch.sqrt(1.0 - a), torch.sqrt(a), torch.sqrt(p),
                dir_coef, sigma]
        for got, w in zip(sc, want):
            assert np.float32(got) == np.float32(float(w))


# --- adaln_norm -------------------------------------------------------------

@pytest.mark.parametrize("B,N,d", [(3, 17, 48), (2, 16, 36), (2, 17, 32)])
def test_adaln_norm_matches_reference(B, N, d):
    x, sc, sh = _normal(1, (B, N, d), (B, d), (B, d))
    sc, sh = 0.5 * sc, 0.5 * sh
    j = [jnp.asarray(a) for a in (x, sc, sh)]
    oracle = j_an_ref.adaln_norm(*j)
    pallas = j_an_ops.adaln_norm(*j, interpret=True)
    port = an_ops.adaln_norm(*(torch.from_numpy(a) for a in (x, sc, sh)))
    assert _max_err(port, oracle) < 1e-5
    assert _max_err(port, pallas) < 1e-5


# --- flash_attention --------------------------------------------------------

@pytest.mark.parametrize("S", [17, 65])
@pytest.mark.parametrize("hd", [32, 36])
def test_attention_noncausal_matches_reference(S, hd):
    q, k, v = _normal(2, *[(2, S, 4, hd)] * 3)
    j = [jnp.asarray(a) for a in (q, k, v)]
    pallas = j_fa_ops.flash_attention(*j, causal=False, interpret=True)
    oracle = j_fa_ref.attention(*(a.transpose(0, 2, 1, 3) for a in j),
                                causal=False).transpose(0, 2, 1, 3)
    port = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False)
    assert port.shape == (2, S, 4, hd)
    assert _max_err(port, oracle) < 2e-5
    assert _max_err(port, pallas) < 2e-5


@pytest.mark.parametrize("Hkv,causal,window,cap", [
    (4, True, 0, 0.0), (2, True, 0, 0.0), (4, True, 8, 30.0)])
def test_attention_ref_other_modes_match_reference(Hkv, causal, window, cap):
    """The plain version keeps every mode of the reference oracle, as the
    kernel on the card does."""
    q, k, v = _normal(3, (2, 4, 24, 32), (2, Hkv, 24, 32), (2, Hkv, 24, 32))
    oracle = j_fa_ref.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, window=window, softcap=cap)
    port = fa_ref.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, softcap=cap)
    assert _max_err(port, oracle) < 2e-5


@pytest.mark.parametrize("Hq,Hkv,causal,window,cap", [
    (8, 4, True, 0, 50.0),            # gemma2's global layers
    (8, 4, True, 16, 50.0),           # its local layers, window < S
    (8, 1, True, 0, 0.0),             # MQA
    (4, 2, False, 0, 0.0)])           # non-causal GQA
def test_attention_ref_and_wrapper_at_head_dim_256(Hq, Hkv, causal, window,
                                                   cap):
    """gemma2's head dim: the plain version against the reference oracle,
    and the wrapper's CPU route against the Pallas kernel in interpret
    mode, at a ragged S = 40 (the Pallas wrapper pads it to 40; the CUDA
    kernel's 32-row tiles leave 8)."""
    q, k, v = _normal(9, (1, 40, Hq, 256), (1, 40, Hkv, 256),
                      (1, 40, Hkv, 256))
    kw = dict(causal=causal, window=window, softcap=cap)
    j = [jnp.asarray(a) for a in (q, k, v)]
    oracle = j_fa_ref.attention(*(a.transpose(0, 2, 1, 3) for a in j), **kw)
    port = fa_ref.attention(*(torch.from_numpy(a).transpose(1, 2)
                              for a in (q, k, v)), **kw)
    assert _max_err(port, oracle) < 2e-5
    pallas = j_fa_ops.flash_attention(*j, interpret=True, **kw)
    wrapper = fa_ops.flash_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)), **kw)
    assert wrapper.shape == (1, 40, Hq, 256)
    assert _max_err(wrapper, pallas) < 2e-5


# --- rmsnorm ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 96), (2, 7, 256), (3, 2304)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(shape, dt):
    """Against the reference's jnp oracle and its Pallas kernel in
    interpret mode, at the reference's own gates (``tests/test_kernels.py``:
    1e-5 in fp32; 5e-2 in bf16, where one bf16 ulp at |y| ~ 4 is 3e-2)."""
    x, s = _normal(10, shape, shape[-1:])
    s = 0.1 * s
    jx = jnp.asarray(x).astype(dt)
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    oracle = j_rn_ref.rmsnorm(jx, jnp.asarray(s))
    pallas = j_rn_ops.rmsnorm(jx, jnp.asarray(s), interpret=True)
    port = rn_ops.rmsnorm(tx, torch.from_numpy(s))
    assert port.dtype == tx.dtype and port.shape == tx.shape
    assert torch.equal(port, rn_ref.rmsnorm(tx, torch.from_numpy(s)))
    tol = 5e-2 if dt == "bfloat16" else 1e-5
    assert _max_err(port.float(), np.asarray(oracle, np.float32)) <= tol
    assert _max_err(port.float(), np.asarray(pallas, np.float32)) <= tol
