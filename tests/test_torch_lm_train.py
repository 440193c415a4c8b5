"""LM training, the port against the JAX package on the CPU:
``train/steps.py`` (``init_train_state``, ``make_train_step``: loss,
gradients, global-norm clipping and AdamW on fp32 master weights),
``remat="full"`` and ``data/lm.py``.

Three steps from the reference's ``init_train_state`` of one key, on
numpy-seeded batches, for hubert-smoke (masked prediction), internvl-smoke
(patches and text), olmoe-smoke (the routers' aux term) and gemma2-smoke
(softcaps, sliding window, post-norms): after each step the loss, ``ce``,
``aux`` and the gradient norm at 1e-5 relative, and every parameter
within 1e-5 of its leaf's largest element plus what a gradient error of
1e-5 of the step's largest gradient element moves AdamW's update.  That
second term is the gate's whole point: AdamW divides each gradient by its
own running RMS, so an element whose gradient is rounding noise (a k
projection's bias: softmax is blind to it, so its true gradient is 0)
moves by ~lr in a direction set by that noise, on either package; its
bound comes from the reference's own moments
(``optimizers.adamw_update_bound``).  The
gradients themselves are held at 1e-5 of the largest element in
``test_torch_frontends.py``; ``tools/adamw_gate_margin.py`` prints the
gradient error these parameters need (at most 1.0e-7 of it on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.data import lm as jdata
from repro.train.steps import (init_train_state as jinit_train_state,
                               make_train_step as jmake_train_step)
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.convert import lm_state_from_jax
from repro_torch.data import lm as tdata
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizers import (AdamWState, adamw_update_bound,
                                          init_adamw)
from repro_torch.optim.optimizers import adamw as tadamw
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_train_step)
from test_torch_frontends import as_jax, as_torch, make_batch
from test_torch_init import assert_states_within_rounding
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL_REL = 1e-5
LR = 3e-4                                    # make_train_step's default
CONFIGS = {"hubert": "hubert-xlarge", "internvl": "internvl2-1b",
           "olmoe": "olmoe-1b-7b", "gemma2": "gemma2-2b"}


def smoke_pair(variant: str):
    name = CONFIGS[variant]
    return (jshapes.smoke_config(jget_config(name)),
            tshapes.smoke_config(get_config(name)))


def port_state(params, tcfg) -> TrainState:
    """A train state of the port on the reference's parameters, fp32."""
    lm = LM(tcfg, device="cpu", param_dtype=torch.float32)
    lm.load_state_dict(lm_state_from_jax(jax.tree.map(np.asarray, params),
                                         tcfg))
    return TrainState(lm, init_adamw({k: v.detach()
                                      for k, v in lm.named_parameters()}))


def as_state(tree, tcfg) -> dict:
    return lm_state_from_jax(jax.tree.map(np.asarray, tree), tcfg)


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_three_train_steps_match_reference(variant):
    jcfg, tcfg = smoke_pair(variant)
    js = jinit_train_state(jax.random.PRNGKey(5), jcfg)
    jstep = jax.jit(jmake_train_step(jcfg))
    ts = port_state(js.params, tcfg)
    step = make_train_step(tcfg)
    start = as_state(js.params, tcfg)
    drift = {k: torch.zeros(()) for k in start}
    for i in range(3):
        batch = make_batch(tcfg, 10 + i, S=24)
        before = AdamWState(i, as_state(js.opt.mu, tcfg), None)
        js, jm = jstep(js, as_jax(batch))
        ts, tm = step(ts, as_torch(batch))
        assert ts.opt.step == int(js.opt.step) == i + 1
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert tm[k].shape == () and tm[k].dtype == torch.float32
            assert abs(float(tm[k]) - float(jm[k])) <= TOL_REL * max(
                abs(float(jm[k])), 1.0), (k, float(tm[k]), float(jm[k]))
        gate = adamw_update_bound(
            before, AdamWState(i + 1, as_state(js.opt.mu, tcfg),
                               as_state(js.opt.nu, tcfg)), lr=LR,
            rel=TOL_REL)
        want, got = as_state(js.params, tcfg), ts.params.state_dict()
        for k, w in want.items():
            drift[k] = drift[k] + gate[k]
            err = (got[k] - w).abs()
            assert bool((err <= TOL_REL * w.abs().max() + drift[k]).all()), \
                (i, k, float(err.max()))
            assert got[k].dtype == torch.float32
    # the weights moved, by ~lr a step
    assert max(float((got[k] - w).abs().max()) for k, w in start.items()) \
        > LR
    if variant == "olmoe":
        assert float(tm["aux"]) > 0


def test_init_train_state_is_the_reference_draw_in_fp32():
    """``init_train_state(key, cfg)``: ``init_lm``'s draw (within a few
    ulps of the reference's), every parameter fp32 even where the
    activations are bf16, zero moments at step 0."""
    jcfg, tcfg = smoke_pair("internvl")
    key = jax.random.PRNGKey(7)
    ts = init_train_state(np.asarray(key), tcfg, device="cpu")
    want = as_state(jinit_train_state(key, jcfg).params, tcfg)
    assert_states_within_rounding(want, ts.params.state_dict())
    assert ts.opt.step == 0 and sorted(ts.opt.mu) == sorted(want)
    assert all(not v.any() for v in (*ts.opt.mu.values(),
                                     *ts.opt.nu.values()))
    bf16 = init_train_state(np.asarray(key), tcfg.replace(dtype="bfloat16"),
                            device="cpu")
    assert all(p.dtype == torch.float32 for p in bf16.params.parameters())
    assert bf16.params.cfg.act_dtype == torch.bfloat16


def test_init_train_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(np.array([0, 1], np.uint32),
                         smoke_pair("hubert")[1])


def test_train_step_refuses_an_lm_of_another_config():
    _, tcfg = smoke_pair("gemma2")
    ts = port_state(jinit_train_state(jax.random.PRNGKey(0),
                                      smoke_pair("gemma2")[0]).params, tcfg)
    step = make_train_step(tcfg.replace(remat="full"))
    with pytest.raises(ValueError, match="got an LM"):
        step(ts, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_full_remat_is_bit_equal_and_recomputes_each_layer():
    """``remat="full"`` (hubert's) recomputes each layer's forward in the
    backward (each layer's first norm runs twice a step, once without
    remat) and gives the same bits: loss, gradient norm and parameters
    after two steps; without grad the forward is the plain one."""
    _, tcfg = smoke_pair("hubert")
    js = jinit_train_state(jax.random.PRNGKey(3), smoke_pair("hubert")[0])
    runs = {}
    for remat in ("none", "full"):
        cfg = tcfg.replace(remat=remat)
        ts = port_state(js.params, cfg)
        calls = []
        hook = ts.params.layers[0].norm1.register_forward_hook(
            lambda *a: calls.append(1))
        step = make_train_step(cfg)
        metrics = []
        for i in range(2):
            ts, m = step(ts, as_torch(make_batch(cfg, 20 + i)))
            metrics.append(m)
        with torch.no_grad():
            ts.params(as_torch(make_batch(cfg, 22)))
        hook.remove()
        runs[remat] = (ts.params.state_dict(), metrics, len(calls))
    (pa, ma, ca), (pb, mb, cb) = runs["none"], runs["full"]
    assert (ca, cb) == (3, 5)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    for a, b in zip(ma, mb):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_kernels_under_grad_raise_before_any_launch(monkeypatch):
    """A train step that asks for the kernel route raises where the
    attention kernel would launch on the card, the kernels having no
    backward; it never drops to the plain route.  Driven on the meta
    device, reported as a CUDA device, with the bindings recording any
    launch instead of making it."""
    launched = []
    for name in ("flash_attention_bshd", "flash_attention_tc_bshd",
                 "flash_attention_short_bshd"):
        monkeypatch.setattr(fa_kernel, name, lambda q, *a, _n=name, **k:
                            launched.append(_n) or torch.empty_like(q))
    _, tcfg = smoke_pair("internvl")
    lm = LM(tcfg, device="meta", param_dtype=torch.float32)
    ts = TrainState(lm, init_adamw({k: v.detach()
                                    for k, v in lm.named_parameters()}))
    batch = {k: torch.as_tensor(v, device="meta")
             for k, v in make_batch(tcfg, 0).items()}
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    step = make_train_step(tcfg, Parallel(use_kernels=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        step(ts, batch)
    assert launched == []
    # without grad the same call reaches the binding (the serving path)
    with torch.no_grad():
        lm(batch, Parallel(use_kernels=True))
    assert len(launched) == tcfg.num_layers
    launched.clear()
    with torch.no_grad():
        lm(batch, Parallel(use_kernels=False))
    assert launched == []


# --- data/lm.py ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["markov", "copy"])
@pytest.mark.parametrize("vocab,seed", [(503, 0), (512, 3), (5000, 1)])
def test_lm_data_is_bit_equal_to_the_reference(kind, vocab, seed):
    """``make_lm_dataset`` (the corpora, their packing) and the batches of
    several seeds and batch sizes, over epochs, bit for bit; above 4096
    states the Markov chain shares the reference's column patterns."""
    kw = dict(seq_len=16, n_tokens=1200, kind=kind, seed=seed)
    ref, port = jdata.make_lm_dataset(vocab, **kw), \
        tdata.make_lm_dataset(vocab, **kw)
    assert port.vocab == ref.vocab == vocab
    assert port.rows.dtype == ref.rows.dtype == np.int32
    assert np.array_equal(port.rows, ref.rows) and port.rows.shape == (75, 16)
    for batch, bseed in ((4, 0), (8, 5), (75, 2)):
        for a, b in zip(ref.batches(batch, seed=bseed, epochs=2),
                        port.batches(batch, seed=bseed, epochs=2)):
            assert np.array_equal(a["tokens"], b["tokens"])
        assert sum(1 for _ in port.batches(batch, seed=bseed, epochs=2)) \
            == 2 * (75 // batch)
    assert np.array_equal(tdata.pack_sequences(np.arange(10), 3),
                          jdata.pack_sequences(np.arange(10), 3))
    gen = tdata.markov_corpus if kind == "markov" else \
        tdata.copy_task_corpus
    jgen = jdata.markov_corpus if kind == "markov" else \
        jdata.copy_task_corpus
    assert np.array_equal(gen(vocab, 333, seed=seed + 7),
                          jgen(vocab, 333, seed=seed + 7))


def test_adamw_update_bound_holds_the_update_of_a_perturbed_gradient():
    """Two AdamW steps on gradients that differ by at most ``rel`` of the
    largest element give updates within ``adamw_update_bound`` of each
    other, elements whose gradient is at that error's size (which AdamW
    normalises to ~lr) included; and the bound is ~2·lr·rel where the
    gradient is the largest."""
    rng = np.random.default_rng(0)
    shape = (64, 32)
    params = {"w": torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))}
    g = rng.standard_normal(shape).astype(np.float32)
    g[:8] *= 1e-6                               # rows at the error's size
    rel, gmax = 1e-5, float(np.abs(g).max())
    state = init_adamw(params)
    for _ in range(2):
        noise = rng.uniform(-1, 1, shape).astype(np.float32) * rel * gmax
        ua, sa = tadamw({"w": torch.from_numpy(g)}, state, params, lr=LR)
        ub, _ = tadamw({"w": torch.from_numpy(g + noise)}, state, params,
                       lr=LR)
        bound = adamw_update_bound(state, sa, lr=LR, rel=rel)["w"]
        diff = (ua["w"] - ub["w"]).abs()
        assert bool((diff <= bound).all())
        assert float(diff[:8].max()) > 10 * float(diff[8:].max())
        top = np.unravel_index(np.abs(g).argmax(), shape)
        assert float(bound[top]) < 3 * LR * rel
        state = sa
