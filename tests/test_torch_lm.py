"""The port's LM (gemma2 configs, layers, attention, ``LM``) against the
JAX package's, on the CPU.

Both packages get the same parameters: the reference's ``init_lm`` tree
with every leaf perturbed by 0.05·normal from a numpy seed (``init_lm``
zero-initialises every norm scale and qkv bias, so unperturbed parameters
would leave those paths untested), carried across by
``convert.lm_state_from_jax``.  Sizes are ``smoke_config(gemma2-2b)``
(4 layers, d 256, 4 heads of 64, window 8) with 20-token prompts, so the
local layers' window masks, and the same config with 2 kv heads, qkv bias
and qk-norm (GQA and the qwen-style flags); the LM's prefill and decode
also run the smoke configs of granite-20b (MQA, qkv bias, a non-gated
gelu MLP, tied embeddings), qwen2-7b (GQA, qkv bias, rope θ 1e6) and
qwen3-32b (qk-norm, a q projection wider than d_model), and those of
jamba-1.5-large at one period (8 layers: 7 Mamba and 1 attention, MoE FFNs
every 2nd layer) and xlstm-125m (2 periods of mLSTM and sLSTM, no FFN),
whose caches are recurrent states; ``test_torch_moe.py`` runs those of the
MoE configs.

Tolerance: 2e-5 in fp32 wherever the two packages compute the same
function, the gate the reference holds its own Pallas kernels to against
its oracle (``tests/test_kernels.py``); what differs is only the order of
fp32 sums in XLA's and torch's CPU kernels.  The LMs with recurrent
mixers (jamba, xlstm) are worse conditioned than that gate: jamba-smoke's
MoE experts, drawn at the reference's std 1/√E = 0.5, grow the residual
stream to ~300 over its 8 layers (an fp32 ulp there is 3e-5), and
xlstm-smoke's sLSTM (recurrent weights at std 1/√H = 0.5, exponential
gates) carries its states' roundings along the sequence.  Moving every
reference weight by one fp32 ulp moves the reference's own outputs there
by more than 2e-5.  So their outputs are held leaf by leaf at max(2e-5, 4·p), p how far that
one-ulp nudge moves the reference's leaf (``probe_gates``; the factor of
4 is ``chip_smoke.py``'s ``K_PROBE``); the mixers alone are held at 2e-5
(``test_torch_ssm.py``).  The same gate holds the whole of xlstm-125m at
full width, on the reference's own draw, over 16 and 64 tokens: there the
nudge moves the reference's logits by 3e-4 and 3e-2
(``tools/xlstm_chaos.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.models.moe import Parallel as JParallel
from repro.models.transformer import (decode_step as jdecode_step,
                                      forward as jforward, init_lm)
from repro.utils import softcap as jsoftcap
from repro_torch import prng
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, list_configs, shapes as tshapes
from repro_torch.convert import lm_state_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM, init_lm as tinit_lm
from repro_torch.utils import softcap
from torch_one_thread import one_thread  # noqa: F401

TOL = 2e-5
S = 20                                   # > the smoke window of 8
# variant -> (registered config, fields replaced in its smoke config)
VARIANTS = {"gemma2": ("gemma2-2b", {}),
            "gqa_bias_qknorm": ("gemma2-2b", dict(num_kv_heads=2,
                                                  qkv_bias=True,
                                                  qk_norm=True))}
LM_VARIANTS = {**VARIANTS, "granite": ("granite-20b", {}),
               "qwen2": ("qwen2-7b", {}), "qwen3": ("qwen3-32b", {}),
               "olmoe": ("olmoe-1b-7b", {}),
               "phi35_moe": ("phi3.5-moe-42b-a6.6b", {}),
               "jamba": ("jamba-1.5-large-398b", dict(num_layers=8)),
               "xlstm": ("xlstm-125m", {})}
NEW_CONFIGS = ["granite-20b", "qwen2-7b", "qwen3-32b", "olmoe-1b-7b",
               "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b", "xlstm-125m",
               "hubert-xlarge", "internvl2-1b"]
# the reference's cache types, by the name of the port's
JCACHES = {"KVCache": jattn.KVCache, "MambaState": jssm.MambaState,
           "MLSTMState": jxlstm.MLSTMState, "SLSTMState": jxlstm.SLSTMState}


def smoke_pair(variant: str):
    """(reference config, port config) of one variant."""
    name, kw = LM_VARIANTS[variant]
    return (jshapes.smoke_config(jget_config(name)).replace(**kw),
            tshapes.smoke_config(get_config(name)).replace(**kw))


def perturbed(tree, seed: int, scale: float = 0.05):
    """Every leaf of ``tree`` as numpy, plus scale·normal from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + scale *
                        rng.standard_normal(a.shape).astype(np.float32), tree)


def lm_pair(variant: str, seed: int = 0):
    """(jcfg, tcfg, reference params (jnp), port LM on the CPU)."""
    jcfg, tcfg = smoke_pair(variant)
    params = perturbed(jax.jit(init_lm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed + 100)
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_from_jax(params, tcfg))
    lm.eval()
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), lm


@pytest.fixture(scope="module",
                params=list(VARIANTS) + ["granite", "qwen2", "qwen3", "jamba",
                                         "xlstm"])
def pair(request):
    return lm_pair(request.param)


def pad_caches(lm, caches, max_len: int):
    """The prefill's caches as the engine pads them: each ``KVCache`` copied
    into a zero cache of ``max_len`` positions, recurrent states as they
    are."""
    full = lm.init_caches(caches[0][0].shape[0], max_len)
    for i, c in enumerate(caches):
        if isinstance(c, tattn.KVCache):
            P = c.k.shape[1]
            full[i].k[:, :P], full[i].v[:, :P] = c.k, c.v
        else:
            full[i] = c
    return full


def stacked(caches, cfg):
    """The port's per-layer caches as the reference's: for each period
    position, its cache type with every leaf stacked along the groups."""
    out = {}
    for p in range(cfg.period):
        per_group = [caches[g * cfg.period + p]
                     for g in range(cfg.num_groups)]
        out[f"p{p}"] = JCACHES[type(per_group[0]).__name__](*(
            jnp.asarray(np.stack([c[i].float().numpy() for c in per_group]))
            for i in range(len(per_group[0]))))
    return out


def _tokens(seed, B=2, L=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


K_PROBE = 4.0


def probe_gates(fn, params, out, cfg):
    """The gate of each leaf of ``out = fn(params)``: TOL for the attention
    stacks; for the recurrent ones max(TOL, K_PROBE·p), p how far moving
    every weight by one fp32 ulp (random signs from a numpy seed) moves
    the reference's leaf."""
    if cfg.mamba is None and cfg.xlstm is None:
        return jax.tree.map(lambda _: TOL, out)
    rng = np.random.default_rng(99)
    nudged = jax.tree.map(lambda a: a * jnp.asarray(
        1 + 2.0 ** -23 * rng.choice([-1.0, 1.0], a.shape), jnp.float32),
        params)
    return jax.tree.map(
        lambda a, b: max(TOL, K_PROBE * float(jnp.max(jnp.abs(a - b)))),
        out, fn(nudged))


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2-2b", "gemma2-2b-swa"] + NEW_CONFIGS)
def test_config_fields_and_derived_values_match_reference(name):
    jc, tc = jget_config(name), get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.act_dtype == torch.bfloat16 and str(jc.act_dtype) == "bfloat16"
    for attr in ("padded_vocab", "period", "num_groups", "supports_decode"):
        assert getattr(tc, attr) == getattr(jc, attr)
    assert tc.param_counts() == jc.param_counts()
    assert [tc.layer_kind(i) for i in range(tc.num_layers)] == \
        [jc.layer_kind(i) for i in range(jc.num_layers)]
    assert dataclasses.asdict(tshapes.smoke_config(tc)) == \
        dataclasses.asdict(jshapes.smoke_config(jc))
    for sname, shape in jbase.INPUT_SHAPES.items():
        tshape = tbase.INPUT_SHAPES[sname]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        assert tshapes.shape_supported(tc, tshape) == \
            jshapes.shape_supported(jc, shape)
        assert tshapes.resolve_decode_config(tc, tshape).name == \
            jshapes.resolve_decode_config(jc, shape).name
    assert tshapes.smoke_shape("decode", 16, 3) == \
        tbase.InputShape("smoke_decode", 16, 3, "decode")
    # the reference's configs, and moonlight-16b-a3b, which it lacks
    assert set(list_configs()) == {"gemma2-2b", "gemma2-2b-swa",
                                   *NEW_CONFIGS, "moonlight-16b-a3b"}


def test_sub_config_defaults_match_reference():
    for t, j in ((tbase.MambaConfig(), jbase.MambaConfig()),
                 (tbase.XLSTMConfig(), jbase.XLSTMConfig()),
                 (tbase.MoEConfig(8, 2, 64), jbase.MoEConfig(8, 2, 64))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tbase.ModelConfig("x", "dense", 2, 64, 4, 2, 128, 100).head_dim \
        == 16


# --- layers -----------------------------------------------------------------

def test_softcap_and_layers_match_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in "ab")
    tx = torch.from_numpy(x)
    assert _err(softcap(tx, 5.0), jsoftcap(jnp.asarray(x), 5.0)) < 1e-6
    assert _err(tlayers.rmsnorm(tx, torch.from_numpy(scale)),
                jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x))) < 1e-5
    assert _err(tlayers.layernorm(tx, torch.from_numpy(scale),
                                  torch.from_numpy(bias)),
                jlayers.layernorm({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)},
                                  jnp.asarray(x))) < 1e-5
    q = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 97, (2, 1))
    assert _err(tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                                   10_000.0),
                jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                   10_000.0)) < 1e-5
    for gated, act in ((True, "gelu"), (False, "silu")):
        p = perturbed(jlayers.init_mlp(jax.random.PRNGKey(1), 64, 128, gated),
                      2)
        mlp = tlayers.MLP(64, 128, gated, act, device="cpu")
        mlp.load_state_dict({f"{k}.weight": torch.from_numpy(
            np.ascontiguousarray(v.T)) for k, v in p.items()})
        want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
        with torch.no_grad():
            assert _err(mlp(tx), want) < TOL


# --- attention --------------------------------------------------------------

def _attn_pair(variant, seed=3):
    jcfg, tcfg = smoke_pair(variant)
    p = perturbed(jattn.init_attention(jax.random.PRNGKey(seed), jcfg),
                  seed + 1)
    mod = tattn.Attention(tcfg, device="cpu")
    state = {}
    for name, node in p.items():
        if "w" in node:
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(node["w"].T))
            if "b" in node:
                state[f"{name}.bias"] = torch.from_numpy(node["b"])
        else:
            state[f"{name}.scale"] = torch.from_numpy(node["scale"])
    mod.load_state_dict(state)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), mod


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kind", ["attn", "attn_local"])
@pytest.mark.parametrize("route", ["kernel", "naive", "chunked"])
def test_attention_routes_match_reference(variant, kind, route):
    """Port ``use_kernels=True`` (the kernel wrapper's plain version on the
    CPU) against the reference's Pallas kernel in interpret mode; the naive
    and chunked routes against the reference's own."""
    jcfg, tcfg, jp, mod = _attn_pair(variant)
    x = np.random.default_rng(4).standard_normal((2, S, 256)).astype(
        np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want, (jk, jv) = jattn.attention(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), kind=kind,
                                     use_pallas=route == "kernel",
                                     impl=route)
    with torch.no_grad():
        got, (k, v) = tattn.attention(mod, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), kind=kind,
                                      use_kernels=route == "kernel",
                                      impl=route)
    assert float(jnp.max(jnp.abs(want))) > 1e-2
    assert _err(got, want) < TOL
    assert _err(k, jk) < TOL and _err(v, jv) < TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_attention_decode_matches_reference(variant, kind):
    """One token at position 13 against a cache of 24 whose first 13
    positions hold data (and whose tail holds junk the mask must hide);
    the port writes the new token into its cache in place."""
    jcfg, tcfg, jp, mod = _attn_pair(variant)
    rng = np.random.default_rng(5)
    hd, hkv = tcfg.head_dim, tcfg.num_kv_heads
    ck, cv = (rng.standard_normal((2, 24, hkv, hd)).astype(np.float32)
              for _ in "kv")
    x = rng.standard_normal((2, 1, 256)).astype(np.float32)
    want, jc = jattn.attention_decode(
        jp, jcfg, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck),
                                                jnp.asarray(cv)),
        jnp.int32(13), kind=kind)
    cache = tattn.KVCache(torch.from_numpy(ck.copy()),
                          torch.from_numpy(cv.copy()))
    with torch.no_grad():
        got, tc = tattn.attention_decode(mod, tcfg, torch.from_numpy(x),
                                         cache, 13, kind=kind)
    assert tc.k is cache.k
    assert _err(got, want) < TOL
    assert _err(tc.k, jc.k) < TOL and _err(tc.v, jc.v) < TOL


def test_make_mask_matches_reference():
    for kw in (dict(causal=True, window=0), dict(causal=True, window=4),
               dict(causal=False, window=3, q_offset=5)):
        assert np.array_equal(tattn.make_mask(9, 14, **kw).numpy(),
                              np.asarray(jattn.make_mask(9, 14, **kw)))


# --- the LM -----------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_logits_and_caches_match_reference(pair, use_kernels):
    jcfg, tcfg, jp, lm = pair
    toks = _tokens(6)
    fn = jax.jit(lambda p: jforward(p, jcfg, {"tokens": jnp.asarray(toks)},
                                    JParallel(use_pallas=use_kernels),
                                    mode="prefill"))
    want, jaux, jcaches = fn(jp)
    tol, _, tol_caches = probe_gates(fn, jp, (want, jaux, jcaches), tcfg)
    with torch.no_grad():
        got, aux, caches = lm(torch.from_numpy(toks),
                              Parallel(use_kernels=use_kernels),
                              mode="prefill")
    assert got.shape == (2, S, tcfg.padded_vocab)
    if tcfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert abs(float(aux) - float(jaux)) < 1e-5
    assert float(jnp.max(jnp.abs(want))) > 1e-1
    assert _err(got, want) < tol
    assert len(caches) == tcfg.num_layers
    for i, c in enumerate(caches):
        g, p = divmod(i, tcfg.period)
        jc = jcaches[f"p{p}"]
        assert type(c).__name__ == type(jc).__name__
        # k, v or the state's leaves
        for a, b, t in zip(c, jc, tol_caches[f"p{p}"]):
            assert _err(a, b[g]) < t


def test_prefill_last_only_and_train_mode(pair):
    jcfg, tcfg, jp, lm = pair
    toks = torch.from_numpy(_tokens(7))
    with torch.no_grad():
        full, _ = lm(toks)
        last, _, _ = lm(toks, Parallel(prefill_last_only=True),
                        mode="prefill")
    assert last.shape == (2, 1, tcfg.padded_vocab)
    # the read-out of one position against that of all: the same sums, but
    # the CPU's matmul blocks a (2, 1, d) product otherwise, ~6 ulps at the
    # logits' size (|logit| ~3)
    assert _err(last[:, 0], full[:, -1]) < 1e-5


def test_prefill_then_decode_matches_forward_and_reference(pair):
    """Prefill 16 tokens, pad the caches to 19, decode 3 more: each step's
    logits against the full forward of all 19 (as the reference's
    ``test_prefill_decode_matches_forward`` does, at its 5e-4) and against
    the reference's ``decode_step`` along its own caches (2e-5); each new
    cache against the reference's step from the same caches, a recurrent
    layer's new state stored back into the caches list."""
    jcfg, tcfg, jp, lm = pair
    toks = _tokens(8, L=19)
    P, K = 16, 3
    with torch.no_grad():
        full, _ = lm(torch.from_numpy(toks))
        lp, _, caches = lm(torch.from_numpy(toks[:, :P]), mode="prefill")
    padded = pad_caches(lm, caches, P + K)
    jcaches = stacked(padded, tcfg)
    step = jax.jit(lambda p, t, c, i: jdecode_step(p, jcfg, t, c, i))
    errs = [_err(lp[:, -1], full[:, P - 1])]
    for i in range(K):
        t, ji = jnp.asarray(toks[:, P + i:P + i + 1]), jnp.int32(P + i)
        before, jin = list(padded), stacked(padded, tcfg)
        with torch.no_grad():
            lg, out = lm.decode_step(torch.from_numpy(toks[:, P + i:P + i + 1]),
                                     padded, P + i)
        own = functools.partial(step, t=t, c=jcaches, i=ji)
        jlg, jcaches = own(jp)
        tol, _ = probe_gates(own, jp, (jlg, jcaches), tcfg)
        errs.append(_err(lg[:, 0], full[:, P + i]))
        assert out is padded and _err(lg, jlg) < tol
        same = functools.partial(step, t=t, c=jin, i=ji)
        want = same(jp)
        _, tol_caches = probe_gates(same, jp, want, tcfg)
        for j, c in enumerate(padded):
            assert (c is before[j]) == isinstance(c, tattn.KVCache)
            g, p = divmod(j, tcfg.period)
            for a, b, gate in zip(c, want[1][f"p{p}"], tol_caches[f"p{p}"]):
                assert _err(a, b[g]) < gate
    assert max(errs) < 5e-4, errs


@pytest.fixture(scope="module")
def xlstm_full():
    """xlstm-125m at full width and depth in fp32: the reference's
    ``init_lm`` draw from key 29 (``chip_smoke.py`` 8h's key) and the port
    on the same weights."""
    jcfg = jget_config("xlstm-125m").replace(dtype="float32")
    tcfg = get_config("xlstm-125m").replace(dtype="float32")
    params = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(29), jcfg)
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_from_jax(jax.tree.map(np.asarray, params),
                                         tcfg))
    return jcfg, tcfg, params, lm.eval()


@pytest.mark.parametrize("L", [16, 64])
def test_xlstm_125m_full_width_matches_reference(xlstm_full, L):
    """The whole of xlstm-125m (12 blocks, d 768) against the reference on
    the same weights: an L-token prefill's logits and every layer's state,
    each leaf at max(2e-5, 4·p), p how far a one-ulp nudge of every weight
    moves the reference's own leaf.  At this width the sLSTM makes the
    function chaotic (``tools/xlstm_chaos.py``): p grows from ~3e-4 at 16
    tokens to ~3e-2 at 64 and to the logits' own size by 128."""
    jcfg, tcfg, params, lm = xlstm_full
    toks = np.random.default_rng(29).integers(
        0, tcfg.vocab_size, (1, L)).astype(np.int32)
    fn = jax.jit(lambda p: jforward(p, jcfg, {"tokens": jnp.asarray(toks)},
                                    JParallel(), mode="prefill"))
    want, jaux, jcaches = fn(params)
    tol, _, tol_caches = probe_gates(fn, params, (want, jaux, jcaches), tcfg)
    with torch.no_grad():
        got, aux, caches = lm(torch.from_numpy(toks), Parallel(),
                              mode="prefill")
    assert float(aux) == 0.0 and got.shape == (1, L, tcfg.padded_vocab)
    assert float(jnp.max(jnp.abs(want))) > 1e-1
    assert _err(got, want) < tol, (_err(got, want), tol)
    for i, c in enumerate(caches):
        g, p = divmod(i, tcfg.period)
        for a, b, t in zip(c, jcaches[f"p{p}"], tol_caches[f"p{p}"]):
            assert _err(a, b[g]) < t


def test_lm_refuses_unported_layers_and_frontends():
    """Mamba and xLSTM layers build (their mixers and the reference's FFN
    rule: none beside an xLSTM block); so do the vision and audio
    frontends and the encoder head (``test_torch_frontends.py`` holds them
    against the reference).  A frontend the reference does not have is
    refused."""
    base = tshapes.smoke_config(get_config("gemma2-2b"))
    for pattern, mixers, ffn in ((("mamba", "attn"), ("Mamba", "Attention"),
                                  True),
                                 (("mlstm", "slstm"), ("mLSTM", "sLSTM"),
                                  False)):
        lm = LM(base.replace(layer_pattern=pattern), device="meta")
        assert [type(layer.mixer).__name__ for layer in lm.layers] == \
            list(mixers) * (base.num_layers // 2)
        assert all((layer.mlp is not None) == ffn for layer in lm.layers)
    for kw, leaf in ((dict(frontend="vision_patches", frontend_dim=64),
                      "frontend_proj"),
                     (dict(frontend="audio_frames", frontend_dim=64),
                      "mask_embed"),
                     (dict(is_encoder=True), "enc_head")):
        lm = LM(base.replace(**kw), device="cpu")
        assert getattr(lm, leaf) is not None
        assert (lm.enc_head is not None) == ("is_encoder" in kw)
    with pytest.raises(ValueError):
        LM(base.replace(frontend="video"), device="cpu")


@pytest.mark.usefixtures("one_thread")
def test_lm_init_is_seeded_and_zeroes_norms():
    """``init_lm`` draws from its key alone (bit for bit again from the same
    key, other weights from another) and zeroes every norm scale and qkv
    bias; the embedding is 0.02·normal.  Against the reference's draw:
    ``test_torch_init.py::test_init_lm_matches_the_reference``."""
    cfg = tshapes.smoke_config(get_config("gemma2-2b")).replace(
        qkv_bias=True, qk_norm=True)
    a, b = (tinit_lm(prng.PRNGKey(3), cfg, device="cpu")
            for _ in range(2))
    other = tinit_lm(prng.PRNGKey(4), cfg, device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(("scale", "bias")):
            assert not pa.any(), name
        else:
            assert not torch.equal(pa, other.state_dict()[name]), name
    assert float(a.embedding.detach().std()) == pytest.approx(0.02, rel=0.05)
