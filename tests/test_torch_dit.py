"""The port's DiT against the JAX package's ``dit_apply``.

Parameters come from the reference ``init_dit``, perturbed 0.05·normal
(adaLN-zero init makes the output exactly 0, which would make the parity
vacuous), and cross over through ``repro_torch.convert``.  The gate is the
reference's own fused-vs-naive gate: 2e-5 per call in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import dit as jdit
from repro_torch import prng
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.convert import dit_state_from_jax
from repro_torch.diffusion import dit as tdit
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 2e-5


def perturbed_params(dc, image_size, channels=3, seed=0, scale=0.05):
    params = jdit.init_dit(jax.random.PRNGKey(seed), dc, image_size, channels)
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.unflatten(treedef, [
        a + scale * jax.random.normal(k, a.shape, a.dtype)
        for a, k in zip(leaves, keys)])


def port_model(params, dc_kwargs, image_size, channels=3):
    model = tdit.DiT(DiffusionConfig(**dc_kwargs), image_size, channels,
                     device="cpu")
    model.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, params)))
    return model


def test_patchify_roundtrip_equals_reference():
    (x,) = [np.random.default_rng(0).standard_normal((2, 16, 8, 3))
            .astype(np.float32)]
    for p in (2, 4):
        ref = np.asarray(jdit.patchify(jnp.asarray(x), p))
        tok = tdit.patchify(torch.from_numpy(x), p)
        assert np.array_equal(tok.numpy(), ref)
        back = tdit.unpatchify(tok, p, 16, 8, 3)
        assert np.array_equal(back.numpy(),
                              np.asarray(jdit.unpatchify(jnp.asarray(ref), p,
                                                         16, 8, 3)))
        assert np.array_equal(back.numpy(), x)


def test_timestep_embedding_matches_reference():
    t = np.arange(0, 1000, 7, dtype=np.int32)
    for dim in (32, 48, 144):
        ref = np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim))
        port = tdit.timestep_embedding(torch.from_numpy(t), dim).numpy()
        # XLA's and torch's float32 exp differ by an ulp on a few
        # frequencies; at t ≈ 1000 that moves the angle by ~6e-5.
        assert np.max(np.abs(port - ref)) < 1e-4


def test_state_dict_covers_every_reference_leaf():
    dc = dict(d_model=32, num_layers=2, num_heads=2)
    params = perturbed_params(JDiffusionConfig(**dc), 16)
    state = dit_state_from_jax(jax.tree.map(np.asarray, params))
    assert len(state) == len(jax.tree.leaves(params))
    assert set(state) == set(port_model(params, dc, 16).state_dict())


@pytest.mark.parametrize("d,layers,heads,patch,B,null_y", [
    (48, 2, 4, 4, 3, False),    # S = 17, head dim 12
    (48, 2, 4, 4, 3, True),     # y = None → the learned null embedding Ø
    (36, 1, 1, 4, 2, False),    # head dim 36 (the paper preset's)
    (32, 1, 2, 2, 2, True),     # S = 65
])
def test_dit_matches_both_reference_paths(d, layers, heads, patch, B, null_y):
    dc = dict(d_model=d, num_layers=layers, num_heads=heads, patch=patch)
    jdc = JDiffusionConfig(**dc)
    params = perturbed_params(jdc, 16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 1000, B).astype(np.int32)
    y = None if null_y else rng.standard_normal((B, 512)).astype(np.float32)
    jy = None if y is None else jnp.asarray(y)
    naive = np.asarray(jdit.dit_apply(params, jdc, jnp.asarray(x),
                                      jnp.asarray(t), jy))
    fused = np.asarray(jdit.dit_apply(params, jdc, jnp.asarray(x),
                                      jnp.asarray(t), jy, use_pallas=True))
    assert np.max(np.abs(naive)) > 1e-3, "vacuous parity"
    model = port_model(params, dc, 16)
    with torch.no_grad():
        ty = None if y is None else torch.from_numpy(y)
        out = model(torch.from_numpy(x), torch.from_numpy(t), ty).numpy()
        model.plain = True
        plain = model(torch.from_numpy(x), torch.from_numpy(t), ty).numpy()
    assert np.max(np.abs(out - naive)) < TOL
    assert np.max(np.abs(out - fused)) < TOL
    assert np.array_equal(out, plain)       # on the CPU both are plain


def test_dit_past_the_short_route_matches_the_reference():
    """image_size 32 at patch 4: S = 65 tokens, past the short kernel's 32,
    so on the card every attention of this DiT goes to the CUDA-core kernel.
    Here the port's plain DiT against the reference's naive and fused
    paths, three layers of 4 heads of 12, at the 2e-5 gate."""
    dc = dict(d_model=48, num_layers=3, num_heads=4, patch=4)
    jdc = JDiffusionConfig(**dc)
    params = perturbed_params(jdc, 32, seed=5)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = rng.integers(0, 1000, 2).astype(np.int32)
    y = rng.standard_normal((2, 512)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    naive = np.asarray(jdit.dit_apply(params, jdc, *args))
    fused = np.asarray(jdit.dit_apply(params, jdc, *args, use_pallas=True))
    assert np.max(np.abs(naive)) > 1e-3, "vacuous parity"
    model = port_model(params, dc, 32)
    assert model.pos.shape[0] + 1 == 65
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(y)).numpy()
    assert np.max(np.abs(out - naive)) < TOL
    assert np.max(np.abs(out - fused)) < TOL


def _bf16_case():
    """The paper preset's head dim (36) at two layers, perturbed params, a
    given and a null conditioning row."""
    dc = dict(d_model=72, num_layers=2, num_heads=2, patch=4)
    params = perturbed_params(JDiffusionConfig(**dc), 16, seed=9)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 1000, 3).astype(np.int32)
    y = rng.standard_normal((3, 512)).astype(np.float32)
    return dc, params, x, t, y


def test_bf16_act_matches_the_reference_fused_path():
    """The kernel path under ``bf16_act`` (on the CPU: the operands rounded
    to bf16 and multiplied in fp32) against the reference's
    ``dit_apply(use_pallas=True)`` under ``bf16_act`` (``dot_general`` of
    bf16 operands into fp32).  The same function (one GEMM of the preset's
    shape agrees to 1.7e-6 at |y| ≤ 6.6), but the two packages' fp32
    operands differ by ulps (the timestep features by up to 6e-5), and an
    operand that straddles a bf16 rounding boundary rounds to the other
    neighbour: one such flip moves its products by a bf16 ulp, as much as
    bf16 rounding itself does.  So the gate is the reference's own
    bf16-vs-fp32 distance on the same input (its test holds that at 2e-2
    of the output's size), halved: measured 1.2e-3 against 3.8e-3."""
    dc, params, x, t, y = _bf16_case()
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    ref16 = np.asarray(jdit.dit_apply(
        params, JDiffusionConfig(**dc, bf16_act=True), *args,
        use_pallas=True))
    ref32 = np.asarray(jdit.dit_apply(params, JDiffusionConfig(**dc), *args))
    dist = float(np.max(np.abs(ref16 - ref32)))
    model = port_model(params, {**dc, "bf16_act": True}, 16)
    calls = tdit.bf16_dense.calls
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(y)).numpy()
    err = float(np.max(np.abs(out - ref16)))
    print(f"bf16_act: port vs the reference's bf16 path {err:.3g}; the "
          f"reference's bf16 vs fp32 path {dist:.3g}")
    assert tdit.bf16_dense.calls - calls == 4 * dc["num_layers"]
    assert out.dtype == np.float32 and np.max(np.abs(ref32)) > 1e-2
    assert dist > 1e-4, "bf16 operands left the output unchanged"
    assert err <= dist / 2


def test_bf16_act_does_nothing_on_the_plain_model():
    """As on the reference's naive path, the flag is inert without the
    kernel path: the plain model gives the same bits with and without it,
    and matches the reference's naive path under the flag at 2e-5."""
    dc, params, x, t, y = _bf16_case()
    want = np.asarray(jdit.dit_apply(
        params, JDiffusionConfig(**dc, bf16_act=True), jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(y)))
    outs = []
    for flag in (True, False):
        model = port_model(params, {**dc, "bf16_act": flag}, 16)
        model.plain = True
        calls = tdit.bf16_dense.calls
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(y)).numpy())
        assert tdit.bf16_dense.calls == calls
    assert np.array_equal(outs[0], outs[1])
    assert np.max(np.abs(outs[0] - want)) < TOL


def test_port_init_is_adaln_zero():
    model = tdit.init_dit(prng.PRNGKey(0),
                          DiffusionConfig(d_model=32, num_layers=1,
                                          num_heads=2), 16, 3, device="cpu")
    with torch.no_grad():
        out = model(torch.randn(2, 16, 16, 3),
                    torch.tensor([3, 900]), torch.randn(2, 512))
    assert torch.count_nonzero(out) == 0
