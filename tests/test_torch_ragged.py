"""The port's ragged, compacted and windowed classifier-free sampling
against the JAX package: ``plan_epochs`` exactly, the plain
``cfg_update_rowwise`` against the reference's oracle and its Pallas
kernel in interpret mode, and the samplers end to end from the same
threefry keys, with nothing injected.

End-to-end gates are the step-aware ones: 5e-4 at smoke depth, 2e-2 at
20 steps.  The smoke-depth cases run on T = 16 with each package's own
schedule and guidance up to 4.0.  Their first step divides by
√ᾱ_15 ≈ 3e-3, and the guidance multiplies the denoiser's per-call
difference by 1 + 2s, so at s = 7.5 the port and the reference drift
apart by up to 7e-4 there (the reference's own Pallas and plain paths
by up to 3.8e-4; ROADMAP, queue 3).  Guidance 7.5 is held at 20 steps,
on T = 50, instead.
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
from repro_torch.diffusion import guidance as tguid
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tsched
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref
from test_torch_dit import perturbed_params, port_model
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                  # pragma: no cover
    from _hypothesis_fallback import given, settings, st

TOL_SMOKE, TOL_DEEP = 5e-4, 2e-2
DC = dict(d_model=32, num_layers=1, num_heads=2)
# the benchmark's mixed workload shape, (s, S), (s', S), (s'', S/2), ...
SMOKE = [(1.5, 4), (4.0, 4), (2.0, 2), (1.5, 2)]
DEEP = [(1.5, 20), (4.0, 20), (7.5, 10), (1.5, 10)]


def _server(T):
    dc = dict(DC, train_timesteps=T)
    jdc = JDiffusionConfig(**dc)
    params = perturbed_params(jdc, 16)
    return (jdc, params, jsched.make_schedule(T), port_model(params, dc, 16),
            tsched.make_schedule(T, device="cpu"))


@pytest.fixture(scope="module")
def server():
    return _server(16)


@pytest.fixture(scope="module")
def deep_server():
    return _server(50)


def _wave(combos, B=8, seed=0):
    y = np.random.default_rng(seed).standard_normal((B, 512)) \
        .astype(np.float32)
    g = np.array([combos[i % len(combos)][0] for i in range(B)], np.float32)
    steps = np.array([combos[i % len(combos)][1] for i in range(B)])
    row_keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return y, g, steps, row_keys


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# --- plan_epochs ------------------------------------------------------------

@settings(max_examples=150, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), B=st.integers(1, 40),
       extra=st.integers(0, 4),
       compaction=st.sampled_from(["full", 1, 2, 3, 7, "auto"]),
       granule=st.sampled_from([1, 2, 8]),
       cost=st.sampled_from([0, 16, 256]))
def test_plan_epochs_equals_reference(seed, B, extra, compaction, granule,
                                      cost):
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 30, B)
    S = int(steps.max()) + extra
    # the "auto" cache: some of the geometries a full plan would compile
    _, full = jguid.plan_epochs(steps, S, granule=granule)
    geoms, prev = set(), 0
    for rows, begin, end in full:
        if rng.random() < 0.5:
            geoms.add((prev, rows, end - begin))
        prev = rows
    kw = dict(compaction=compaction, granule=granule, geoms=geoms,
              compile_cost=cost)
    r_order, r_epochs = jguid.plan_epochs(steps, S, **kw)
    p_order, p_epochs = tguid.plan_epochs(steps, S, **kw)
    assert np.array_equal(p_order, r_order)
    assert p_epochs == r_epochs


@pytest.mark.parametrize("steps,S,kw", [
    ([], 4, {}), ([0, 3], 4, {}), ([5, 3], 4, {}),
    ([2, 3], 4, dict(compaction=0)), ([2, 3], 4, dict(compaction="some")),
    ([2, 3], 4, dict(compaction=True))])
def test_plan_epochs_refuses_what_the_reference_refuses(steps, S, kw):
    with pytest.raises(ValueError) as ref:
        jguid.plan_epochs(np.array(steps, np.int32), S, **kw)
    with pytest.raises(ValueError) as port:
        tguid.plan_epochs(np.array(steps, np.int32), S, **kw)
    assert str(port.value) == str(ref.value)


def test_compacted_refuses_malformed_plans(server):
    _, _, _, model, sched = server
    y, g, steps, keys = _wave(SMOKE)
    ts, ab_t, ab_prev, jloc = tguid.ragged_tables(sched, steps, 4)
    order, epochs = tguid.plan_epochs(steps, 4)
    (r0, b0, e0), (r1, b1, e1) = epochs
    bad = [(), ((r0, b0, e0),), ((r0, b0, e0), (r1 - 1, b1, e1)),
           ((r0, b0 - 1, e0), (r1, b1, e1)), ((r0, b0, e0), (r1, b1 + 1, e1)),
           ((r0 - 1, b0, e0), (r1, b1, e1)), ((r1, b0 + 1, e0), (r1, b1, e1))]
    sorted_args = [np.asarray(a)[order] for a in (g, ts, ab_t, ab_prev,
                                                  jloc)]
    for plan in bad:
        with pytest.raises(ValueError):
            tguid.reverse_sample_compacted(
                model, torch.from_numpy(y[order]), np.asarray(keys)[order],
                *sorted_args, epochs=plan, image_size=16)


# --- cfg_update_rowwise -----------------------------------------------------

def _rowwise_inputs(Bs, seed=0):
    """Per-row scalars of a (Bs,) table with a t = 999 first step of a
    4-step trajectory, a last step, a mid step and an inactive row."""
    rng = np.random.default_rng(seed)
    table = [(2.0, 2.4288882e-09, 0.24600048, 1), (7.5, 0.3, 0.6, 1),
             (1.5, 0.9, 1.0, 1), (4.0, 0.05, 0.2, 0)]
    rows = [table[i % 4] for i in range(Bs)]
    s, ab_t, ab_prev, act = (np.array(c, np.float32) for c in zip(*rows))
    return s, ab_t, ab_prev, act.astype(bool), rng


@pytest.mark.parametrize("B,Bs,off", [(4, 4, 0), (3, 8, 0), (3, 8, 5),
                                      (2, 6, 1)])
def test_cfg_update_rowwise_matches_reference(B, Bs, off):
    s, ab_t, ab_prev, active, rng = _rowwise_inputs(Bs)
    x, ec, eu, z = (rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
                    for _ in range(4))
    j = [jnp.asarray(a) for a in (x, ec, eu, z)]
    oracle = j_cfg_ref.cfg_update_rowwise_windowed(
        j[0], j[1], j[2], s, ab_t, ab_prev, j[3], active, row_offset=off)
    pallas = j_cfg_ops.cfg_update_rowwise(j[0], j[1], j[2], s, ab_t, ab_prev,
                                          j[3], active, row_offset=off,
                                          interpret=True)
    t = [torch.from_numpy(a) for a in (x, ec, eu, z)]
    port = cfg_ops.cfg_update_rowwise(t[0], t[1], t[2], s, ab_t, ab_prev,
                                      t[3], active, row_offset=off)
    assert _err(port, oracle) < 1e-5 and _err(port, pallas) < 1e-5
    for b in range(B):
        w = off + b
        if active[w]:        # each active row is the scalar update, bitwise
            one = cfg_ref.cfg_update(t[0][b], t[1][b], t[2][b], float(s[w]),
                                     ab_t[w], ab_prev[w], t[3][b])
            assert torch.equal(port[b], one)
        else:
            assert torch.equal(port[b], t[0][b])


def test_cfg_update_rowwise_refuses_out_of_range_offsets():
    s, ab_t, ab_prev, active, rng = _rowwise_inputs(6)
    x = torch.from_numpy(rng.standard_normal((4, 4, 4, 3)).astype(np.float32))
    for off in (-1, 3, 6):
        with pytest.raises(ValueError):
            cfg_ops.cfg_update_rowwise(x, x, x, s, ab_t, ab_prev, x, active,
                                       row_offset=off)
        with pytest.raises(ValueError):
            j_cfg_ops.cfg_update_rowwise(*[jnp.asarray(x.numpy())] * 3, s,
                                         ab_t, ab_prev, jnp.asarray(x.numpy()),
                                         active, row_offset=off,
                                         interpret=True)


def test_rowwise_coeffs_round_like_the_plain_version():
    """The kernel's host table equals the plain version's float32 tensor
    arithmetic bit for bit, row by row, t = 999 first step included."""
    s, ab_t, ab_prev, active, _ = _rowwise_inputs(8)
    table = cfg_ops.rowwise_coeffs(s, ab_t, ab_prev, active, 1.0)
    assert table.shape == (8, 8) and table.dtype == np.float32
    a, p = torch.from_numpy(ab_t), torch.from_numpy(ab_prev)
    var = (1.0 - p) / (1.0 - a) * (1.0 - a / p)
    sigma = 1.0 * torch.sqrt(torch.clamp(var, min=0.0))
    want = [1.0 + torch.from_numpy(s), torch.from_numpy(s),
            torch.sqrt(1.0 - a), torch.sqrt(a), torch.sqrt(p),
            torch.sqrt(torch.clamp(1.0 - p - sigma ** 2, min=0.0)), sigma,
            torch.from_numpy(active).float()]
    for i, w in enumerate(want):
        assert np.array_equal(table[i], w.numpy()), i
    # a (steps, rows) table stacks one (8, rows) table per step
    stacked = cfg_ops.rowwise_coeffs(s, np.stack([ab_t, ab_t]),
                                     np.stack([ab_prev, ab_prev]),
                                     np.stack([active, active]), 1.0)
    assert stacked.shape == (2, 8, 8) and np.array_equal(stacked[1], table)


# --- the samplers, end to end -----------------------------------------------

def _ref_and_port(server, kind, combos, **kw):
    jdc, params, jsch, model, sched = server
    y, g, steps, keys = _wave(combos)
    rk = np.asarray(keys)
    if kind == "ragged":
        ref = jsampler.sample_cfg_ragged(params, jdc, jsch, jnp.asarray(y),
                                         keys, g, steps, **kw)
        port = tsampler.sample_cfg_ragged(model, sched, y, rk, g, steps, **kw)
    else:
        ref = jsampler.sample_cfg_compacted(params, jdc, jsch, jnp.asarray(y),
                                            keys, g, steps, **kw)
        port = tsampler.sample_cfg_compacted(model, sched, y, rk, g, steps,
                                             **kw)
    return np.asarray(ref), port.numpy()


@pytest.mark.parametrize("kind,kw", [
    ("ragged", {}), ("ragged", dict(max_steps=6)),
    ("compacted", dict(compaction="full")), ("compacted", dict(compaction=1)),
    ("compacted", dict(compaction="auto", compile_cost=0, granule=3))])
def test_ragged_samplers_match_reference_at_smoke_depth(server, kind, kw):
    ref, port = _ref_and_port(server, kind, SMOKE, **kw)
    assert port.shape == (8, 16, 16, 3)
    assert float(np.abs(ref).max()) > 1e-2
    assert _err(port, ref) < TOL_SMOKE


def test_ragged_sampler_matches_reference_at_20_steps(deep_server):
    ref, port = _ref_and_port(deep_server, "ragged", DEEP)
    assert _err(port, ref) < TOL_DEEP


def test_window_sampler_matches_reference_and_the_whole_wave(server):
    """A wave served as two windows against the wide scalar table: each
    window against the reference's window, and both against the port's
    own one-shot ragged wave (packing is gated at tolerance)."""
    jdc, params, jsch, model, sched = server
    y, g, steps, keys = _wave(SMOKE)
    rk = np.asarray(keys)
    whole = tsampler.sample_cfg_ragged(model, sched, y, rk, g, steps).numpy()
    for off, rows in ((0, 3), (3, 5)):
        w = slice(off, off + rows)
        ref = jsampler.sample_cfg_window(params, jdc, jsch,
                                         jnp.asarray(y[w]), keys[w], g, steps,
                                         row_offset=off)
        port = tsampler.sample_cfg_window(model, sched, y[w], rk[w], g, steps,
                                          row_offset=off).numpy()
        assert port.shape == (rows, 16, 16, 3)
        assert _err(port, ref) < TOL_SMOKE
        assert _err(port, whole[w]) < TOL_SMOKE
    with pytest.raises(ValueError):
        tsampler.sample_cfg_window(model, sched, y[:3], rk[:3], g, steps,
                                   row_offset=6)
    with pytest.raises(ValueError):
        tsampler.sample_cfg_window(model, sched, y[:3], rk[:2], g, steps,
                                   row_offset=0)


def test_ragged_rows_do_not_depend_on_their_wave(server):
    """Row keys make a row's value independent of packing: a row sampled
    inside a mixed wave equals the same row sampled alone, within the
    packing tolerance."""
    _, _, _, model, sched = server
    y, g, steps, keys = _wave(SMOKE)
    rk = np.asarray(keys)
    whole = tsampler.sample_cfg_ragged(model, sched, y, rk, g, steps,
                                       max_steps=4).numpy()
    compact = tsampler.sample_cfg_compacted(model, sched, y, rk, g,
                                            steps).numpy()
    for b in (0, 2, 7):
        alone = tsampler.sample_cfg_ragged(
            model, sched, y[b:b + 1], rk[b:b + 1], g[b:b + 1],
            steps[b:b + 1]).numpy()
        assert _err(alone[0], whole[b]) < TOL_SMOKE
    assert _err(compact, whole) < TOL_SMOKE
