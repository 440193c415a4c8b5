"""The port's classifier-guided, unconditional and mixed-guidance paths
against the JAX package, from the same threefry keys: the plain
``cfg_update_mixed`` against the reference's oracle and its Pallas kernel
in interpret mode, the samplers end to end, and the engine serving all
three modes in grouped, ragged and compacted waves.

Gates are the step-aware ones of ``test_torch_ragged``: 5e-4 at smoke
depth (T = 16, guidance up to 4.0 on classifier-free rows, 1.0 on
classifier-guided rows), 2e-2 at 20 steps (T = 50).  The classifiers are
the reference benchmark's analytic ones (``_clf_center``, ``_clf_pull``
in ``benchmarks/synthesis_throughput.py``), written once in jnp and once in
torch, and a ResNet-18 with the same weights in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import guidance as jguid
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jsched
from repro.kernels.cfg_fuse import ops as j_cfg_ops
from repro.kernels.cfg_fuse import ref as j_cfg_ref
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.diffusion import guidance as tguid
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tsched
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref
from repro_torch.models import classifiers as tclf
from repro_torch.serve import synthesis as tsynth
from repro_torch.serve.synthesis import STAT_KEYS, SynthesisEngine
from test_torch_classifiers import jax_logprob, random_classifier
from test_torch_dit import perturbed_params, port_model

TOL_SMOKE, TOL_DEEP = 5e-4, 2e-2
DC = dict(d_model=32, num_layers=1, num_heads=2, sample_timesteps=3)


def j_center(x, labels):
    return -jnp.sum(x ** 2, axis=(1, 2, 3))


def j_pull(x, labels):
    pull = labels.astype(x.dtype)[:, None, None, None]
    return -jnp.sum((x - 0.1 * pull) ** 2, axis=(1, 2, 3))


def t_center(x, labels):
    return -torch.sum(x ** 2, dim=(1, 2, 3))


def t_pull(x, labels):
    pull = labels.to(x.dtype)[:, None, None, None]
    return -torch.sum((x - 0.1 * pull) ** 2, dim=(1, 2, 3))


J_CLFS, T_CLFS = (j_center, j_pull), (t_center, t_pull)


def _server(T):
    dc = dict(DC, train_timesteps=T)
    jdc = JDiffusionConfig(**dc)
    params = perturbed_params(jdc, 16)
    return (jdc, params, jsched.make_schedule(T), port_model(params, dc, 16),
            tsched.make_schedule(T, device="cpu"))


@pytest.fixture(scope="module")
def server():
    return _server(16)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# --- cfg_update_mixed -------------------------------------------------------

def _mixed_inputs(Bs, seed=0):
    """Per-row scalars with a t = 999 first step of a 4-step trajectory, a
    mid step, a last step and an inactive row, and modes 0, 1, 1, 0, 1, ..."""
    rng = np.random.default_rng(seed)
    table = [(2.0, 2.4288882e-09, 0.24600048, 1), (7.5, 0.3, 0.6, 1),
             (1.5, 0.9, 1.0, 1), (4.0, 0.05, 0.2, 0)]
    rows = [table[i % 4] for i in range(Bs)]
    s, ab_t, ab_prev, act = (np.array(c, np.float32) for c in zip(*rows))
    mode = (np.arange(Bs) % 3 != 0).astype(np.float32)
    return mode, s, ab_t, ab_prev, act.astype(bool), rng


@pytest.mark.parametrize("B,Bs,off", [(4, 4, 0), (3, 8, 0), (3, 8, 5),
                                      (2, 6, 1)])
def test_cfg_update_mixed_matches_reference(B, Bs, off):
    mode, s, ab_t, ab_prev, active, rng = _mixed_inputs(Bs)
    x, ec, eu, z = (rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
                    for _ in range(4))
    j = [jnp.asarray(a) for a in (x, ec, eu, z)]
    oracle = j_cfg_ref.cfg_update_mixed_windowed(
        j[0], j[1], j[2], mode, s, ab_t, ab_prev, j[3], active,
        row_offset=off)
    pallas = j_cfg_ops.cfg_update_mixed(j[0], j[1], j[2], mode, s, ab_t,
                                        ab_prev, j[3], active, row_offset=off,
                                        interpret=True)
    t = [torch.from_numpy(a) for a in (x, ec, eu, z)]
    port = cfg_ops.cfg_update_mixed(t[0], t[1], t[2], mode, s, ab_t, ab_prev,
                                    t[3], active, row_offset=off)
    assert _err(port, oracle) < 1e-6 and _err(port, pallas) < 1e-6
    for b in range(B):
        w = off + b
        if not active[w]:
            assert torch.equal(port[b], t[0][b])
        elif mode[w] >= 0.5:      # ε_c is the guided ε̂: the plain step
            one = cfg_ref.ancestral_step(t[0][b], t[1][b], ab_t[w],
                                         ab_prev[w], t[3][b])
            assert torch.equal(port[b], one)


def test_cfg_update_mixed_all_mode_0_is_rowwise_and_mode_1_ignores_s_eu():
    _, s, ab_t, ab_prev, active, rng = _mixed_inputs(6)
    x, ec, eu, junk, z = (torch.from_numpy(
        rng.standard_normal((6, 8, 8, 3)).astype(np.float32))
        for _ in range(5))
    zero, one = np.zeros(6, np.float32), np.ones(6, np.float32)
    assert torch.equal(
        cfg_ops.cfg_update_mixed(x, ec, eu, zero, s, ab_t, ab_prev, z,
                                 active),
        cfg_ops.cfg_update_rowwise(x, ec, eu, s, ab_t, ab_prev, z, active))
    assert torch.equal(
        cfg_ops.cfg_update_mixed(x, ec, junk, one, s, ab_t, ab_prev, z,
                                 active),
        cfg_ops.cfg_update_mixed(x, ec, eu, zero, zero, ab_t, ab_prev, z,
                                 active))


def test_cfg_update_mixed_refuses_out_of_range_offsets():
    mode, s, ab_t, ab_prev, active, rng = _mixed_inputs(6)
    x = torch.from_numpy(rng.standard_normal((4, 4, 4, 3)).astype(np.float32))
    for off in (-1, 3, 6):
        with pytest.raises(ValueError, match="out of range"):
            cfg_ops.cfg_update_mixed(x, x, x, mode, s, ab_t, ab_prev, x,
                                     active, row_offset=off)


@pytest.fixture
def launches_recorded(monkeypatch):
    """The per-row wrappers' CUDA side driven with meta tensors: the input
    checks that need a card pass, and the kernel bindings record each
    launch instead of making it."""
    launched = []
    monkeypatch.setattr(cfg_ops, "_check_update_inputs", lambda *a: None)
    for name in ("cfg_update_rowwise_flat", "cfg_update_mixed_flat"):
        monkeypatch.setattr(
            cfg_ops.K, name, lambda x, *a, _n=name, **k:
            launched.append(_n) or torch.empty_like(x))
    return launched


def _per_row(wrapper, x, B=4, Bs=6, **kw):
    """One call of the rowwise or mixed wrapper over meta tensors shaped
    like ``x``, with host vectors of ``Bs`` slots."""
    mode, s, ab_t, ab_prev, active, _ = _mixed_inputs(Bs)
    if wrapper == "rowwise":
        return cfg_ops.cfg_update_rowwise(x, x, x, s, ab_t, ab_prev, x,
                                          active, **kw)
    return cfg_ops.cfg_update_mixed(x, x, x, mode, s, ab_t, ab_prev, x,
                                    active, **kw)


@pytest.mark.parametrize("wrapper", ["rowwise", "mixed"])
def test_per_row_wrappers_refuse_other_dtypes_before_launching(
        launches_recorded, wrapper):
    """fp32 only on the card: a bf16 call raises before any launch."""
    x = torch.zeros(4, 8, 8, 3, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="fp32 only"):
        _per_row(wrapper, x)
    assert launches_recorded == []


@pytest.mark.parametrize("wrapper", ["rowwise", "mixed"])
def test_per_row_wrappers_launch_nothing_for_an_empty_batch(
        launches_recorded, wrapper):
    fn = getattr(cfg_ops, f"cfg_update_{wrapper}")
    before = fn.launches
    out = _per_row(wrapper, torch.zeros(0, 8, 8, 3, device="meta"))
    assert out.shape == (0, 8, 8, 3) and out.device.type == "meta"
    assert launches_recorded == [] and fn.launches == before


@pytest.mark.parametrize("wrapper", ["rowwise", "mixed"])
def test_per_row_wrappers_check_the_table_before_launching(
        launches_recorded, wrapper):
    """The device table must be the wrapper's own shape ((8, Bs) rowwise,
    (9, Bs) mixed), float32 and contiguous; the one the wrapper forms
    itself is, and launches once."""
    x = torch.zeros(4, 8, 8, 3, device="meta")
    rows = 8 if wrapper == "rowwise" else 9
    fn = getattr(cfg_ops, f"cfg_update_{wrapper}")
    for bad in (torch.zeros(17 - rows, 6), torch.zeros(rows, 5),
                torch.zeros(rows, 6, dtype=torch.float64),
                torch.zeros(6, rows).T):
        with pytest.raises(ValueError, match="coeffs"):
            _per_row(wrapper, x, coeffs=bad.to("meta"))
    assert launches_recorded == []
    before = fn.launches
    _per_row(wrapper, x, row_offset=2)
    assert launches_recorded == [f"cfg_update_{wrapper}_flat"]
    assert fn.launches == before + 1


def test_mixed_coeffs_are_the_rowwise_table_and_the_mode():
    mode, s, ab_t, ab_prev, active, _ = _mixed_inputs(8)
    table = cfg_ops.mixed_coeffs(mode, s, ab_t, ab_prev, active, 1.0)
    assert table.shape == (9, 8) and table.dtype == np.float32
    assert np.array_equal(table[:8], cfg_ops.rowwise_coeffs(
        s, ab_t, ab_prev, active, 1.0))
    assert np.array_equal(table[8], mode)
    stacked = cfg_ops.mixed_coeffs(mode, s, np.stack([ab_t] * 3),
                                   np.stack([ab_prev] * 3),
                                   np.stack([active] * 3), 1.0)
    assert stacked.shape == (3, 9, 8) and np.array_equal(stacked[2], table)


# --- the uniform samplers ---------------------------------------------------

def test_sample_uncond_matches_reference(server):
    jdc, params, jsch, model, sched = server
    key = jax.random.PRNGKey(3)
    ref = jsampler.sample_uncond(params, jdc, jsch, 4, key, num_steps=4)
    port = tsampler.sample_uncond(model, sched, 4, np.asarray(key),
                                  num_steps=4)
    assert port.shape == (4, 16, 16, 3)
    assert float(np.abs(ref).max()) > 1e-2
    assert _err(port, ref) < TOL_SMOKE


@pytest.mark.parametrize("which,steps", [(0, 4), (1, 4), (1, 2)])
def test_sample_classifier_guided_matches_reference(server, which, steps):
    jdc, params, jsch, model, sched = server
    key = jax.random.PRNGKey(4)
    labels = np.array([1, 3, 5, 7], np.int32)
    ref = jsampler.sample_classifier_guided(
        params, jdc, jsch, J_CLFS[which], jnp.asarray(labels), key,
        num_steps=steps, guidance=1.0)
    port = tsampler.sample_classifier_guided(
        model, sched, T_CLFS[which], labels, np.asarray(key),
        num_steps=steps, guidance=1.0)
    assert float(np.abs(ref).max()) > 1e-2
    assert _err(port, ref) < TOL_SMOKE


def test_sample_classifier_guided_with_a_resnet_matches_reference(server):
    jdc, params, jsch, model, sched = server
    cparams, clf = random_classifier("resnet18", seed=1)
    key = jax.random.PRNGKey(5)
    labels = np.array([2, 6, 9], np.int32)
    ref = jsampler.sample_classifier_guided(
        params, jdc, jsch, jax_logprob(cparams, "resnet18"),
        jnp.asarray(labels), key, num_steps=3, guidance=1.0)
    port = tsampler.sample_classifier_guided(
        model, sched, tclf.classifier_logprob(clf), labels, np.asarray(key),
        num_steps=3, guidance=1.0)
    unguided = tsampler.sample_classifier_guided(
        model, sched, tclf.classifier_logprob(clf), labels, np.asarray(key),
        num_steps=3, guidance=0.0)
    assert _err(port, ref) < TOL_SMOKE
    assert _err(port, unguided) > 10 * TOL_SMOKE      # the gradient acts


# --- the mixed samplers -----------------------------------------------------

def _mixed_wave(params, deep=False, B=8, seed=0):
    """Rows of all three modes: classifier-free at (s, S) and (s', S/2),
    classifier-guided on both classifiers, unconditional."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, 512)).astype(np.float32)
    mode = np.array([0, 1, 0, 1, 0, 1, 0, 0][:B], np.float32)
    y[mode == 1] = np.asarray(params["null_y"])
    y[B - 1] = np.asarray(params["null_y"])           # the unconditional row
    g = np.array([1.5, 1.0, 4.0, 1.0, 2.0, 1.0, 7.5 if deep else 1.5, 0.0],
                 np.float32)[:B]
    steps = np.array([4, 4, 2, 2, 4, 3, 2, 3][:B]) * (5 if deep else 1)
    cids = np.array([0, 0, 0, 1, 0, 1, 0, 0][:B])
    labels = np.arange(B) % 10
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return y, g, mode, cids, labels, steps, keys


def _ref_and_port(server, kind, **kw):
    jdc, params, jsch, model, sched = server
    y, g, mode, cids, labels, steps, keys = _mixed_wave(
        params, deep=sched.T > 16)
    rk = np.asarray(keys)
    if kind == "ragged":
        ref = jsampler.sample_mixed(params, jdc, jsch, jnp.asarray(y), keys,
                                    g, mode, cids, labels, steps,
                                    clf_fns=J_CLFS, **kw)
        port = tsampler.sample_mixed(model, sched, y, rk, g, mode, cids,
                                     labels, steps, clf_fns=T_CLFS, **kw)
    else:
        ref = jsampler.sample_mixed_compacted(
            params, jdc, jsch, jnp.asarray(y), keys, g, mode, cids, labels,
            steps, clf_fns=J_CLFS, **kw)
        port = tsampler.sample_mixed_compacted(
            model, sched, y, rk, g, mode, cids, labels, steps,
            clf_fns=T_CLFS, **kw)
    return np.asarray(ref), port.numpy()


@pytest.mark.parametrize("kind,kw", [
    ("ragged", {}), ("ragged", dict(max_steps=6)),
    ("compacted", dict(compaction="full")), ("compacted", dict(compaction=1)),
    ("compacted", dict(compaction="auto", compile_cost=0, granule=3))])
def test_mixed_samplers_match_reference_at_smoke_depth(server, kind, kw):
    ref, port = _ref_and_port(server, kind, **kw)
    assert port.shape == (8, 16, 16, 3)
    assert float(np.abs(ref).max()) > 1e-2
    assert _err(port, ref) < TOL_SMOKE


def test_mixed_sampler_matches_reference_at_20_steps():
    ref, port = _ref_and_port(_server(50), "ragged")
    assert _err(port, ref) < TOL_DEEP


def test_mixed_window_sampler_matches_reference_and_the_whole_wave(server):
    """A mixed wave served as two windows: each against the reference's
    jitted window segment, and both against the port's whole wave."""
    jdc, params, jsch, model, sched = server
    y, g, mode, cids, labels, steps, keys = _mixed_wave(params)
    rk = np.asarray(keys)
    whole = tsampler.sample_mixed(model, sched, y, rk, g, mode, cids, labels,
                                  steps, clf_fns=T_CLFS).numpy()
    ts, ab_t, ab_prev, jloc = jguid.ragged_tables(jsch, steps, 4)
    for off, rows in ((0, 3), (3, 5)):
        w = slice(off, off + rows)
        ref = jnp.clip(jsampler._window_segment_mixed(
            params, jdc, jnp.zeros((0, 16, 16, 3)), jnp.asarray(y[w]),
            keys[w], jnp.asarray(g), ts[w], jloc[w], ab_t, ab_prev,
            jloc >= 0, mode=jnp.asarray(mode), clf_ids=jnp.asarray(cids[w]),
            labels=jnp.asarray(labels[w]), clf_fns=J_CLFS, row_offset=off,
            image_size=16, channels=3, eta=1.0, use_pallas=False), -1, 1)
        port = tsampler.sample_mixed_window(
            model, sched, y[w], rk[w], g, mode, cids[w], labels[w], steps,
            clf_fns=T_CLFS, row_offset=off).numpy()
        assert port.shape == (rows, 16, 16, 3)
        assert _err(port, ref) < TOL_SMOKE
        assert _err(port, whole[w]) < TOL_SMOKE
    with pytest.raises(ValueError):
        tsampler.sample_mixed_window(model, sched, y[:3], rk[:3], g, mode,
                                     cids[:2], labels[:3], steps,
                                     clf_fns=T_CLFS, row_offset=0)
    with pytest.raises(ValueError):
        tsampler.sample_mixed_window(model, sched, y[:3], rk[:3], g, mode,
                                     cids[:3], labels[:3], steps,
                                     clf_fns=T_CLFS, row_offset=6)


def test_compacted_mixed_wave_permutes_the_classifier_operands(server):
    """Compaction sorts rows by activation: the classifier rows must keep
    their own classifier and label through the permutation, so the
    compacted wave equals the one-shot wave row for row."""
    _, params, _, model, sched = server
    y, g, mode, cids, labels, steps, keys = _mixed_wave(params)
    rk = np.asarray(keys)
    args = (model, sched, y, rk, g, mode, cids, labels, steps)
    whole = tsampler.sample_mixed(*args, clf_fns=T_CLFS).numpy()
    compact = tsampler.sample_mixed_compacted(*args, clf_fns=T_CLFS).numpy()
    assert _err(compact, whole) < TOL_SMOKE
    swapped = tsampler.sample_mixed_compacted(
        *args[:6], 1 - cids, *args[7:], clf_fns=T_CLFS).numpy()
    clf_rows = mode == 1
    assert _err(swapped[~clf_rows], whole[~clf_rows]) < TOL_SMOKE
    assert _err(swapped[clf_rows], whole[clf_rows]) > 10 * TOL_SMOKE


# --- the engine -------------------------------------------------------------

def _submit_all(eng, enc, clfs):
    combos = [(1.5, 4), (4.0, 4), (2.0, 2), (1.5, 2)]
    rids = [eng.submit(enc[i], i, 2 + i % 3, guidance=combos[i][0],
                       num_steps=combos[i][1]) for i in range(4)]
    rids += [eng.submit_classifier_guided(clfs[c], c, 3, guidance=1.0,
                                          num_steps=4 - 2 * c,
                                          group=("clf", c))
             for c in range(2)]
    rids += [eng.submit_unconditional(2 + c, category=c, num_steps=2 + 2 * c)
             for c in range(2)]
    return rids


@pytest.mark.parametrize("mode", [dict(), dict(ragged=True),
                                  dict(compaction="full")],
                         ids=["grouped", "ragged", "full"])
def test_engine_serves_three_modes_like_the_reference(server, mode):
    jdc, params, jsch, model, sched = server
    enc = np.random.default_rng(1).standard_normal((4, 512)) \
        .astype(np.float32)
    ref = JEngine(params, jdc, jsch, image_size=16, wave_size=8, cache=False,
                  **mode)
    port = SynthesisEngine(model, sched, image_size=16, wave_size=8, **mode)
    assert _submit_all(port, enc, T_CLFS) == _submit_all(ref, enc, J_CLFS)
    key = jax.random.PRNGKey(2)
    want = ref.run(key)
    got = port.run(np.asarray(key))
    assert sorted(got) == sorted(want)
    for rid, rows in want.items():
        assert got[rid].shape == rows.shape
        assert _err(got[rid].numpy(), rows) < TOL_SMOKE, rid
    assert port.stats == {k: ref.stats[k] for k in STAT_KEYS}
    assert port.stats["generated"] == 22


def test_engine_dispatches_the_mixed_sampler_only_for_classifier_rows(
        server, monkeypatch):
    """A ragged wave of classifier-free and unconditional rows keeps the
    pure classifier-free sampler; one classifier row makes it mixed."""
    _, _, _, model, sched = server
    calls = []
    for name in ("sample_cfg_ragged", "sample_mixed"):
        fn = getattr(tsynth, name)
        monkeypatch.setattr(tsynth, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    enc = np.random.default_rng(2).standard_normal((2, 512)) \
        .astype(np.float32)
    eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                          ragged=True)
    eng.submit(enc[0], 0, 3, guidance=2.0, num_steps=2)
    eng.submit_unconditional(3, category=1, num_steps=3)
    eng.run(prng.PRNGKey(0))
    assert calls == ["sample_cfg_ragged"]
    eng.submit(enc[1], 0, 3, guidance=2.0, num_steps=2)
    eng.submit_classifier_guided(t_center, 2, 2, num_steps=2)
    eng.run(prng.PRNGKey(0))
    assert calls == ["sample_cfg_ragged", "sample_mixed"]


def test_engine_refuses_repeated_unconditional_never_classifier(server):
    """The reference keys an unconditional request by (category, steps) in
    its cache and caches no classifier-guided request: the port, which has
    no cache, refuses the first kind of repeat and serves the second."""
    _, _, _, model, sched = server
    eng = SynthesisEngine(model, sched, image_size=16, ragged=True)
    eng.submit_unconditional(2, category=3, num_steps=2)
    eng.submit_unconditional(1, category=3, num_steps=2)
    with pytest.raises(NotImplementedError):
        eng.run(prng.PRNGKey(0))
    eng = SynthesisEngine(model, sched, image_size=16, ragged=True)
    eng.submit_unconditional(2, category=3, num_steps=2)
    eng.submit_unconditional(2, category=3, num_steps=3)    # other steps
    eng.submit_classifier_guided(t_center, 1, 2, num_steps=2)
    eng.submit_classifier_guided(t_center, 1, 2, num_steps=2)
    assert [len(v) for v in eng.run(prng.PRNGKey(0)).values()] == [2] * 4
    eng.submit_classifier_guided(t_center, 1, 2, num_steps=2)  # a later run
    assert len(eng.run(prng.PRNGKey(1))) == 1
    eng.submit_unconditional(1, category=3, num_steps=2)
    with pytest.raises(NotImplementedError):
        eng.run(prng.PRNGKey(2))
