"""The port's audio and vision frontends, its encoder head and ``loss_fn``
against the JAX package's, on the CPU.

hubert-smoke (2 layers, d 256, 4/4 heads of 64, a non-gated gelu MLP, an
encoder: bidirectional attention, ``enc_head``) reads 64-d frames through
``frontend_proj`` with ``mask_embed`` on the masked ones; internvl-smoke (2
layers, GQA 4/2, qkv bias, tied embeddings) puts 4 projected 64-d patches
before its text tokens.  Both packages get the reference's ``init_lm`` tree
perturbed by 0.05·normal (``test_torch_lm.perturbed``: the zero norm
scales, biases and the zero-initialised paths are exercised), carried
across by ``convert.lm_state_from_jax``; batches are made by numpy from a
seed.  Tolerance 2e-5 (``test_torch_lm.TOL``): the two packages compute
the same function in fp32 and differ in the order of sums.  ``loss_fn``'s
gradients are held at 1e-5 of the largest gradient element: the premise
of the train-step gate in ``test_torch_lm_train.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models.moe import Parallel as JParallel
from repro.models.transformer import (decode_step as jdecode_step,
                                      forward as jforward, init_lm,
                                      loss_fn as jloss_fn)
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.convert import lm_state_from_jax
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM, loss_fn
from repro_torch.serve.engine import ServeEngine
from test_torch_lm import TOL, _err, pad_caches, perturbed, stacked
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CONFIGS = {"hubert": "hubert-xlarge", "internvl": "internvl2-1b",
           "olmoe": "olmoe-1b-7b"}
TOL_GRAD = 1e-5          # of the largest gradient element


def smoke_pair(variant: str):
    name = CONFIGS[variant]
    return (jshapes.smoke_config(jget_config(name)),
            tshapes.smoke_config(get_config(name)))


@functools.lru_cache(maxsize=None)
def lm_pair(variant: str, seed: int = 0):
    """(jcfg, tcfg, reference params (numpy), port LM on the CPU in fp32)
    on the reference's ``init_lm`` tree perturbed 0.05·normal."""
    jcfg, tcfg = smoke_pair(variant)
    params = perturbed(jax.jit(init_lm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed + 100)
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(lm_state_from_jax(params, tcfg))
    return jcfg, tcfg, params, lm.eval()


def make_batch(cfg, seed: int, B: int = 2, S: int = 20) -> dict:
    """The reference's batch for ``cfg`` (as numpy): S tokens; S frames
    with a 30% mask and labels; or ``num_prefix_tokens`` patches and the
    rest text."""
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
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal(
            (B, P, cfg.frontend_dim)).astype(np.float32)
    return batch


def _paths(tree):
    """(path string, leaf) of every leaf of a reference tree."""
    return [(jax.tree_util.keystr(k), a)
            for k, a in jax.tree_util.tree_leaves_with_path(tree)]


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# --- the LM's frontends and heads -------------------------------------------

def test_frontend_lms_hold_the_reference_leaves():
    """hubert: ``frontend_proj``, ``mask_embed``, ``enc_head``, no
    ``lm_head``, and the token table it never reads (``padded_vocab``
    rows, as the reference allocates it); internvl: ``frontend_proj``, tied
    embeddings, no head of its own.  Full width builds on the meta
    device; an unknown frontend is refused."""
    for variant in ("hubert", "internvl"):
        _, tcfg = smoke_pair(variant)
        lm = LM(tcfg, device="meta")
        names = set(lm.state_dict())
        assert lm.frontend_proj.weight.shape == (tcfg.d_model,
                                                 tcfg.frontend_dim)
        assert lm.embedding.shape == (tcfg.padded_vocab, tcfg.d_model)
        assert ("mask_embed" in names) == (variant == "hubert")
        assert ("enc_head.weight" in names) == (variant == "hubert")
        assert not any(n.startswith("lm_head") for n in names)
    for name in ("hubert-xlarge", "internvl2-1b"):
        ref = jax.eval_shape(lambda k, n=name: init_lm(k, jget_config(n)),
                             jax.random.PRNGKey(0))
        full = LM(get_config(name), device="meta")
        assert sum(p.numel() for p in full.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
        assert len(list(full.parameters())) == sum(
            a.shape[0] if a.ndim and "groups" in path else 1
            for path, a in _paths(ref))
        assert all(p.dtype == torch.bfloat16 for n_, p in
                   full.named_parameters() if not n_.endswith("scale"))
    with pytest.raises(ValueError):
        LM(smoke_pair("hubert")[1].replace(frontend="video"), device="meta")


@pytest.mark.parametrize("variant", ["hubert", "internvl"])
@pytest.mark.parametrize("route", ["kernel", "naive", "chunked"])
def test_train_logits_match_reference(variant, route):
    """``forward(batch, mode="train")`` on each attention route against
    the reference's same route (its Pallas kernel in interpret mode for
    the port's kernel wrapper, whose CPU side is the plain version):
    hubert's non-causal attention, internvl's causal attention over patches
    and text."""
    jcfg, tcfg, params, lm = lm_pair(variant)
    batch = make_batch(tcfg, 1)
    want, jaux = jforward(jax.tree.map(jnp.asarray, params), jcfg,
                          as_jax(batch),
                          JParallel(use_pallas=route == "kernel",
                                    attn_impl=route if route != "kernel"
                                    else "naive"))
    with torch.no_grad():
        got, aux = lm(as_torch(batch), Parallel(
            use_kernels=route == "kernel",
            attn_impl=route if route != "kernel" else "naive"))
    assert got.shape == (2, 20, tcfg.padded_vocab) and float(aux) == 0.0
    assert float(jnp.max(jnp.abs(want))) > 1e-1
    assert _err(got, want) < TOL


def test_encoder_attention_is_not_causal():
    """A frame late in the clip moves the encoder's output at the first
    frame (bidirectional), and a text token moves no patch position of the
    VLM's (causal, patches first)."""
    for variant, pos in (("hubert", 0), ("internvl", 0)):
        _, tcfg, _, lm = lm_pair(variant)
        batch = make_batch(tcfg, 2)
        moved = {k: v.copy() for k, v in batch.items()}
        key = "frames" if variant == "hubert" else "tokens"
        moved[key][:, -1] += 1
        with torch.no_grad():
            a, _ = lm(as_torch(batch))
            b, _ = lm(as_torch(moved))
        changed = float((a[:, pos] - b[:, pos]).abs().max())
        assert (changed > 1e-3) == (variant == "hubert"), (variant, changed)


def test_vlm_prefill_on_patches_then_decode_matches_reference():
    """internvl-smoke: prefill 4 patches and 12 text tokens, pad the caches
    to 19, decode 3 tokens: logits and caches against the reference's
    ``forward(mode="prefill")`` and ``decode_step`` from the same caches,
    and each step against the full forward of patches and 15 tokens."""
    jcfg, tcfg, params, lm = lm_pair("internvl")
    jp = jax.tree.map(jnp.asarray, params)
    full_batch = make_batch(tcfg, 3, S=19)
    P, K = 16, 3
    batch = dict(full_batch, tokens=full_batch["tokens"][:, :P - 4])
    want, _, jcaches = jforward(jp, jcfg, as_jax(batch), JParallel(),
                                mode="prefill")
    with torch.no_grad():
        full, _ = lm(as_torch(full_batch))
        lp, _, caches = lm(as_torch(batch), mode="prefill")
    assert lp.shape == (2, P, tcfg.padded_vocab)
    assert _err(lp, want) < TOL
    for i, c in enumerate(caches):
        for a, b in zip(c, jcaches["p0"]):
            assert _err(a, b[i]) < TOL
    padded = pad_caches(lm, caches, P + K)
    jc = stacked(padded, tcfg)
    step = jax.jit(lambda p, t, c, i: jdecode_step(p, jcfg, t, c, i))
    toks = full_batch["tokens"]
    errs = []
    for i in range(K):
        t = toks[:, P - 4 + i:P - 3 + i]
        with torch.no_grad():
            lg, padded = lm.decode_step(torch.from_numpy(t), padded, P + i)
        jlg, jc = step(jp, jnp.asarray(t), jc, jnp.int32(P + i))
        assert _err(lg, jlg) < TOL
        errs.append(_err(lg[:, 0], full[:, P + i]))
    for g, c in enumerate(padded):
        for a, b in zip(c, jc["p0"]):
            assert _err(a, b[g]) < TOL
    assert max(errs) < 5e-4, errs


def test_serve_engine_refuses_an_encoder():
    """hubert has no decode step: the engine refuses it, as the
    reference's does."""
    from repro.serve.engine import ServeEngine as JServeEngine
    jcfg, tcfg, params, lm = lm_pair("hubert")
    assert not tcfg.supports_decode
    with pytest.raises(AssertionError, match="encoder-only"):
        JServeEngine(jcfg, params)
    with pytest.raises(AssertionError, match="encoder-only"):
        ServeEngine(tcfg, lm)


# --- loss_fn ------------------------------------------------------------------

def _grads(lm, batch):
    lm.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(lm, as_torch(batch))
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for k, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    return loss, metrics, grads


@pytest.mark.parametrize("variant", ["hubert", "internvl", "olmoe"])
def test_loss_fn_and_gradients_match_reference(variant):
    """Each branch of ``loss_fn``: hubert's masked prediction (the mean NLL
    over the masked frames), internvl's next-token loss over the text
    (the patch positions out), olmoe's next-token loss plus its routers'
    load-balance term.  Loss, ``ce`` and ``aux`` at 2e-5; every gradient,
    the token table an encoder never reads included (zero in both), at
    1e-5 of the largest gradient element."""
    jcfg, tcfg, params, lm = lm_pair(variant)
    batch = make_batch(tcfg, 4)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, as_jax(batch)), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    loss, metrics, grads = _grads(lm, batch)
    loss = loss.detach()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(jl)) < TOL
    for k in ("ce", "aux"):
        assert abs(float(metrics[k].detach()) - float(jm[k])) < TOL, k
    aux, ce = (float(metrics[k].detach()) for k in ("aux", "ce"))
    if variant == "olmoe":
        assert aux > 0 and float(loss) > ce
    else:
        assert aux == 0 and float(loss) == ce
    want = lm_state_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert sorted(want) == sorted(grads)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        assert float((grads[k] - v).abs().max()) <= TOL_GRAD * gmax, k
    if variant == "hubert":
        assert not grads["embedding"].any() and not want["embedding"].any()


def test_encoder_loss_counts_at_least_one_frame():
    """With no frame masked the denominator is 1 and the loss 0, as the
    reference's ``max(sum(mask), 1)`` gives; a clip masked everywhere
    averages over every frame."""
    jcfg, tcfg, params, lm = lm_pair("hubert")
    jp = jax.tree.map(jnp.asarray, params)
    for fill in (False, True):
        batch = make_batch(tcfg, 5)
        batch["mask"] = np.full_like(batch["mask"], fill)
        jl, _ = jloss_fn(jp, jcfg, as_jax(batch))
        with torch.no_grad():
            loss, _ = loss_fn(lm, as_torch(batch))
        assert abs(float(loss) - float(jl)) < TOL
        assert (float(loss) == 0.0) == (not fill)


def test_tree_round_trips_through_the_state():
    """The reference's tree (``frontend_proj``, ``mask_embed`` and
    ``enc_head`` included) through ``convert.lm_state_from_jax`` into the
    LM and back out of ``state_dict``: every leaf of the tree lands in
    exactly one parameter (the counts of values and of group slices
    agree), bit for bit, the new leaves in their own names."""
    for variant, new in (("hubert", {"frontend_proj.weight": (
            "frontend_proj", "w"), "mask_embed": ("mask_embed",),
            "enc_head.weight": ("enc_head", "w")}),
            ("internvl", {"frontend_proj.weight": ("frontend_proj", "w")})):
        _, tcfg, params, lm = lm_pair(variant)
        got = lm.state_dict()
        want = lm_state_from_jax(params, tcfg)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert sum(v.numel() for v in got.values()) == sum(
            a.size for a in jax.tree.leaves(params))
        assert len(got) == sum(a.shape[0] if "groups" in path else 1
                               for path, a in _paths(params))
        for name, path in new.items():
            leaf = functools.reduce(lambda t, k: t[k], path, params)
            leaf = leaf.T if path[-1] == "w" else leaf
            assert np.array_equal(got[name].numpy(), leaf), name
