"""Initial weights from a key, the port against the JAX package: the
uniform, Bernoulli and truncated-normal draws, the DiT's and the six
classifiers' key-drawn inits.  ``run_oscar`` from one key with nothing
injected is ``test_torch_train.py::test_run_oscar_matches_reference
[from-key]``, beside the injected cases and their fixture.

jax's truncated normal is √2·erfinv(u), u uniform between XLA's float32
erf of the bounds; the port's ``erfinv`` is within 3 ulps of XLA's (its
``log1p`` and fused multiply-adds), so a draw is within 3 ulps, i.e. a
relative 3·2^-23.  Scaling by a float32 constant keeps the relative error
and each side rounds its product or quotient once more (2^-24 each), so
the inits are gated at a relative 4·2^-23 per element (zeros exactly).
The LM's ``init_lm`` is held the same way at a gemma2 smoke config, with
and without an untied head, qkv bias and qk-norm, and at the smoke configs
of jamba (Mamba's dt bias from a uniform draw, ``A_log``, ``D``), xlstm
(mLSTM's and sLSTM's gate biases, sLSTM's recurrent weights), hubert (the
frames' ``frontend_proj``, ``mask_embed`` and the encoder's ``enc_head``,
drawn from the key an LM head takes) and internvl (the patches'
``frontend_proj``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import dit as jdit
from repro.models import classifiers as jclf
from repro.models import transformer as jlm
from repro_torch import prng
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.convert import (classifier_state_from_jax,
                                 dit_state_from_jax, lm_state_from_jax)
from repro_torch.core import classifier_train as tct
from repro_torch.diffusion import dit as tdit
from repro_torch.models import classifiers as tclf
from repro_torch.models import transformer as tlm
from torch_one_thread import one_thread  # noqa: F401

TOL_REL = 4 * 2.0 ** -23


def ulps(a, b) -> int:
    """Largest distance in float32 ulps between two same-signed arrays."""
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def assert_states_within_rounding(want: dict, got: dict) -> None:
    """Every leaf within TOL_REL of the other's, but Mamba's dt bias:
    dt + log1p(-exp(-dt)) at dt in [1e-3, 1e-1] cancels, so an ulp of
    exp(-dt) (2^-24 just below 1; XLA's and torch's exp differ by one)
    moves it by 2^-24/(1 - exp(-dt)), up to 6e-5 at dt = 1e-3: held at
    four such ulps."""
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        w, g = want[k].double().numpy(), v.double().numpy()
        if k.endswith("dt_proj.bias"):
            one_minus = -np.expm1(-np.log1p(np.exp(w)))   # 1 - exp(-dt)
            err = np.abs(g - w) * one_minus / 2.0 ** -24
            assert np.all(err <= 4), (k, float(err.max()))
            continue
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        assert np.all((g == w) | (rel <= TOL_REL)), (k, float(rel.max()))


# -- the draws ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (33, 65)])
def test_uniform_and_bernoulli_are_bit_equal_to_jax(shape):
    for seed in (0, 3, 11):
        key = jax.random.PRNGKey(seed)
        k = np.asarray(key)
        assert np.array_equal(prng.uniform(k, shape).numpy(),
                              np.asarray(jax.random.uniform(key, shape)))
        lo, hi = -0.75, 2.5
        assert np.array_equal(
            prng.uniform(k, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=lo,
                                          maxval=hi)))
        for p in (0.1, 0.4, 0.5, 0.0, 1.0):
            got = prng.bernoulli(k, p, shape)
            assert got.dtype.is_floating_point is False
            assert np.array_equal(got.numpy(), np.asarray(
                jax.random.bernoulli(key, p, shape)))
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    ref = np.stack([np.asarray(jax.random.bernoulli(kk, 0.4, (9,)))
                    for kk in keys])
    assert np.array_equal(prng.bernoulli(np.asarray(keys), 0.4, (9,)).numpy(),
                          ref)


def test_erf_constants_equal_xla():
    """The truncation bounds' erf as XLA rounds them in float32 (the
    initialisers' ±2, and ±1), and within a few ulps across the range."""
    bounds = np.float32([-2, 2, -1, 1, -3, 0.5]) / np.float32(np.sqrt(2))
    assert np.array_equal(prng.erf_f32(bounds),
                          np.asarray(jax.lax.erf(jnp.asarray(bounds))))
    x = np.random.default_rng(0).uniform(-3.5, 3.5, 20000).astype(np.float32)
    assert ulps(prng.erf_f32(x), np.asarray(jax.lax.erf(jnp.asarray(x)))) <= 8


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0)])
def test_truncated_normal_is_within_ulps_of_jax(bounds):
    lo, hi = bounds
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.truncated_normal(key, lo, hi, (40, 50)))
        got = prng.truncated_normal(np.asarray(key), lo, hi, (40, 50))
        assert str(got.dtype) == f"torch.{ref.dtype}"
        assert np.array_equal(np.sign(got.numpy()), np.sign(ref))
        assert ulps(got.numpy(), ref) <= 3
        assert lo < float(got.min()) and float(got.max()) < hi


# -- the inits ------------------------------------------------------------------

DIT = dict(d_model=48, num_layers=2, num_heads=4)


def test_init_dit_matches_the_reference():
    key = jax.random.PRNGKey(7)
    ref = jax.jit(jdit.init_dit, static_argnums=(1, 2, 3))(
        key, JDiffusionConfig(**DIT), 16, 3)
    want = dit_state_from_jax(jax.tree.map(np.asarray, ref))
    model = tdit.init_dit(np.asarray(key), DiffusionConfig(**DIT), 16, 3,
                          device="cpu")
    assert_states_within_rounding(want, model.state_dict())
    assert all(p.is_leaf and p.requires_grad for p in model.parameters())
    # the key alone fixes the bits; another key other weights
    again = tdit.init_dit(np.asarray(key), DiffusionConfig(**DIT), 16, 3,
                          device="cpu").state_dict()
    assert all(np.array_equal(v.numpy(), again[k].numpy())
               for k, v in model.state_dict().items())
    other = tdit.init_dit(prng.PRNGKey(8), DiffusionConfig(**DIT), 16, 3,
                          device="cpu")
    assert not np.array_equal(other.pos.detach().numpy(),
                              model.pos.detach().numpy())


@pytest.mark.parametrize("name", tclf.CLASSIFIERS)
def test_classifier_init_matches_the_reference(name):
    key = jax.random.PRNGKey(21)
    # jitted: an eager init_classifier compiles each draw for seconds
    ref = jax.jit(jclf.init_classifier, static_argnums=(1, 2))(key, name, 7)
    want = classifier_state_from_jax(jax.tree.map(np.asarray, ref), name)
    got = tclf.init_classifier(np.asarray(key), name, 7, device="cpu")
    assert_states_within_rounding(want, got.state_dict())
    assert type(got) is type(tclf.classifier_module(name, 7,
                                                    device="meta"))


LM_VARIANTS = {"gemma2": ("gemma2-2b", {}),
               "head_bias_qknorm": ("gemma2-2b", dict(
                   num_kv_heads=2, qkv_bias=True, qk_norm=True,
                   tie_embeddings=False)),
               "granite": ("granite-20b", {}), "qwen2": ("qwen2-7b", {}),
               "qwen3": ("qwen3-32b", {}),
               "jamba": ("jamba-1.5-large-398b", dict(num_layers=8)),
               "xlstm": ("xlstm-125m", {}),
               "hubert": ("hubert-xlarge", {}),
               "internvl": ("internvl2-1b", {})}


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("variant", list(LM_VARIANTS))
def test_init_lm_matches_the_reference(variant):
    name, kw = LM_VARIANTS[variant]
    jcfg = jshapes.smoke_config(jget_config(name)).replace(**kw)
    tcfg = tshapes.smoke_config(get_config(name)).replace(**kw)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(jlm.init_lm, static_argnums=1)(key, jcfg)
    want = lm_state_from_jax(jax.tree.map(np.asarray, ref), tcfg)
    lm = tlm.init_lm(np.asarray(key), tcfg, device="cpu")
    assert_states_within_rounding(want, lm.state_dict())
    assert all(p.is_leaf and p.requires_grad for p in lm.parameters())


@pytest.mark.usefixtures("one_thread")
def test_init_lm_draws_a_leaf_in_pieces_with_one_draws_bits(monkeypatch):
    """A leaf drawn in pieces (the card's way for gemma2-2b's 590 M-value
    embedding) gives the bits of one draw: each piece takes the counters
    the whole draw gives it."""
    tcfg = tshapes.smoke_config(get_config("gemma2-2b"))
    key = prng.PRNGKey(12)
    whole = tlm.init_lm_tree(key, tcfg, device="cpu")
    monkeypatch.setattr(tlm, "DRAW_PIECE", 1 << 14)
    pieces = tlm.init_lm_tree(key, tcfg, device="cpu")
    flat_a, flat_b = (jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), tree)) for tree in (whole, pieces))
    assert len(flat_a) == len(flat_b) > 0
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    assert whole["embed"]["embedding"].numel() >= 8 << 14


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_lm_converter_takes_both_trees_of_the_recurrent_configs(name):
    """``lm_state_from_jax`` on the reference's ``init_lm`` tree and on the
    port's ``init_lm_tree``, at 2 groups (jamba 16 layers with narrow FFNs,
    xlstm 4 layers): the names and shapes ``LM`` holds, within rounding of
    each other; bare leaves keep their name and the reference's layout
    (layer g·period + p takes slice g), the dense matrices are transposed.
    The fan-in quirk is kept: ``lecun_init`` takes axis 0, so Mamba's
    (d_conv, d_inner) conv is drawn at std 1/√d_conv and sLSTM's (H, hd,
    4·hd) recurrent weights at 1/√H."""
    jcfg = jshapes.smoke_config(jget_config(name))
    tcfg = tshapes.smoke_config(get_config(name))
    if tcfg.moe is not None:          # the FFNs' widths do not matter here
        narrow = dict(d_ff=64, moe=dataclasses.replace(tcfg.moe,
                                                       d_ff_expert=64))
        jcfg, tcfg = jcfg.replace(**narrow), tcfg.replace(**narrow)
    assert tcfg.num_groups == 2
    key = jax.random.PRNGKey(17)
    ref = jax.tree.map(np.asarray,
                       jax.jit(jlm.init_lm, static_argnums=1)(key, jcfg))
    want = lm_state_from_jax(ref, tcfg)
    mine = lm_state_from_jax(tlm.init_lm_tree(np.asarray(key), tcfg, "cpu"),
                             tcfg)
    state = tlm.LM(tcfg, device="meta").state_dict()
    assert sorted(want) == sorted(mine) == sorted(state)
    assert all(v.shape == state[k].shape for k, v in want.items())
    assert_states_within_rounding(want, mine)
    g, p = 1, 1                                   # layer period + 1
    leaf = ref["groups"][f"p{p}"]["mixer"]
    i = g * tcfg.period + p
    if tcfg.mamba is not None:
        bare = ("conv_w", "conv_b", "A_log", "D")
        dense = leaf["dt_proj"]["w"][g].T
        got_dense = want[f"layers.{i}.mixer.dt_proj.weight"]
        fan_in = ("conv_w", tcfg.mamba.d_conv)
    else:
        bare = ("w_r", "b")
        dense = leaf["w_x"]["w"][g].T
        got_dense = want[f"layers.{i}.mixer.w_x.weight"]
        fan_in = ("w_r", tcfg.num_heads)
    for k in bare:
        np.testing.assert_array_equal(want[f"layers.{i}.mixer.{k}"].numpy(),
                                      leaf[k][g])
    np.testing.assert_array_equal(got_dense.numpy(), dense)
    bound = float(mine[f"layers.{i}.mixer.{fan_in[0]}"].abs().max()) \
        * np.sqrt(fan_in[1])
    assert 1.9 < bound <= 2.0                   # truncated at 2 std
