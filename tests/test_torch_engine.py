"""The port's synthesis engine and ``synthesize`` against the JAX
package's, from the same threefry key and the same uploads, with nothing
injected: grouped waves, ragged waves and fully compacted ragged waves.

Images are gated at 5e-4 (smoke depth, T = 16, each package's own
schedule; guidance up to 4.0, see ``test_torch_ragged``).  The engine's
counters are integers of the schedule and must equal the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.core import oscar as joscar
from repro.diffusion import schedule as jsched
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.core import oscar as toscar
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tsched
from repro_torch.serve.synthesis import STAT_KEYS, SynthesisEngine
from test_torch_dit import perturbed_params, port_model
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 5e-4
DC = dict(d_model=32, num_layers=1, num_heads=2, train_timesteps=16,
          sample_timesteps=3)
MIXED = [(1.5, 4), (4.0, 4), (2.0, 2), (1.5, 2)]
MODES = [dict(), dict(ragged=True), dict(compaction="full")]


@pytest.fixture(scope="module")
def server():
    jdc = JDiffusionConfig(**DC)
    params = perturbed_params(jdc, 16)
    return (jdc, params, jsched.make_schedule(16), port_model(params, DC, 16),
            tsched.make_schedule(16, device="cpu"))


def _uploads(seed=0):
    enc = np.random.default_rng(seed).standard_normal((2, 3, 512)) \
        .astype(np.float32)
    present = np.ones((2, 3), bool)
    present[1, 1] = False
    return enc, present


@pytest.mark.parametrize("mode", MODES, ids=["grouped", "ragged", "full"])
def test_synthesize_matches_reference(server, mode):
    jdc, params, jsch, model, sched = server
    enc, present = _uploads()
    key = jax.random.PRNGKey(5)
    ref_x, ref_y = joscar.synthesize(key, params, jdc, jsch, enc, present, 4,
                                     image_size=16, guidance=2.0, wave_size=8,
                                     **mode)
    x, y = toscar.synthesize(np.asarray(key), model, sched, enc, present, 4,
                             image_size=16, guidance=2.0, wave_size=8, **mode)
    assert x.shape == (20, 16, 16, 3) and x.dtype == torch.float32
    assert np.array_equal(y.numpy(), ref_y)
    assert float(np.abs(ref_x).max()) > 1e-2
    assert float(np.max(np.abs(x.numpy() - ref_x))) < TOL


@pytest.mark.parametrize("mode", MODES + [dict(compaction="auto"),
                                          dict(compaction=2)],
                         ids=["grouped", "ragged", "full", "auto", "K2"])
def test_engine_mixed_requests_match_reference(server, mode):
    """Requests at mixed (guidance, steps) and counts: the same rows, the
    same waves, padding and row-iterations, and images within the gate."""
    jdc, params, jsch, model, sched = server
    enc, _ = _uploads(1)
    ref = JEngine(params, jdc, jsch, image_size=16, wave_size=8, **mode)
    port = SynthesisEngine(model, sched, image_size=16, wave_size=8, **mode)
    for i, (r, c) in enumerate((r, c) for r in range(2) for c in range(3)):
        g, steps = MIXED[i % len(MIXED)]
        kw = dict(guidance=g, num_steps=steps)
        assert port.submit(enc[r, c], c, 2 + i % 3, **kw) == \
            ref.submit(enc[r, c], c, 2 + i % 3, **kw)
    key = jax.random.PRNGKey(2)
    want = ref.run(key)
    got = port.run(np.asarray(key))
    assert sorted(got) == sorted(want)
    for rid, rows in want.items():
        assert got[rid].shape == rows.shape
        assert float(np.max(np.abs(got[rid].numpy() - rows))) < TOL, rid
    assert port.stats == {k: ref.stats[k] for k in STAT_KEYS}
    assert port.stats["generated"] == 18
    assert port.stats["padded"] > 0


def test_grouped_waves_are_sample_cfg_calls_on_wave_keys(server):
    """Grouped wave i of a drain is ``sample_cfg(fold_in(key, i))`` on its
    rows, groups drained in sorted (guidance, steps) order."""
    _, _, _, model, sched = server
    enc, _ = _uploads(2)
    eng = SynthesisEngine(model, sched, image_size=16, wave_size=8)
    a = eng.submit(enc[0, 0], 0, 5, guidance=4.0, num_steps=2)
    b = eng.submit(enc[0, 1], 1, 3, guidance=1.5, num_steps=3)
    key = prng.PRNGKey(9)
    out = eng.run(key)
    # each group is one wave of 8 rows, padded by repeating its last row
    first = tsampler.sample_cfg(model, sched,
                                np.repeat(enc[0, 1][None], 8, 0),
                                prng.fold_in(key, 0), num_steps=3,
                                guidance=1.5)
    second = tsampler.sample_cfg(model, sched,
                                 np.repeat(enc[0, 0][None], 8, 0),
                                 prng.fold_in(key, 1), num_steps=2,
                                 guidance=4.0)
    assert torch.equal(out[b], first[:3]) and torch.equal(out[a], second[:5])
    assert eng.stats["waves"] == 2 and eng.stats["padded"] == 8


def test_engine_serves_repeats_and_top_ups_like_the_reference(server):
    """The row cache against the reference's: a repeat of (encoding,
    guidance, steps) in the same drain takes only the rows the first one
    does not plan, and in a later drain it is served from the first one's
    rows bit for bit with no wave; a larger count generates only the
    top-up rows (within the gate of the reference's); another guidance is
    its own entry.  Grouped and ragged waves, the same counters."""
    jdc, params, jsch, model, sched = server
    enc, _ = _uploads()
    for mode in (dict(), dict(ragged=True)):
        ref = JEngine(params, jdc, jsch, image_size=16, wave_size=8, **mode)
        port = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                               **mode)
        drains = ([(2, 2.0), (3, 2.0), (2, 4.0)], [(2, 2.0), (6, 2.0)])
        outs = []
        for i, reqs in enumerate(drains):
            for eng in (ref, port):
                for count, g in reqs:
                    eng.submit(enc[0, 0], 0, count, guidance=g, num_steps=2)
            key = jax.random.PRNGKey(i)
            want, got = ref.run(key), port.run(np.asarray(key))
            assert sorted(got) == sorted(want)
            for rid, rows in want.items():
                assert got[rid].shape == rows.shape
                assert float(np.max(np.abs(got[rid].numpy() - rows))) < TOL
            assert port.stats == {k: ref.stats[k] for k in STAT_KEYS}
            outs.append(got)
        first, later = outs
        assert torch.equal(first[1][:2], first[0])       # planned, not drawn
        assert torch.equal(later[3], first[0])           # served from cache
        assert torch.equal(later[4][:3], first[1])       # the top-up's prefix
        assert float((later[4][3:] - first[1][:3]).abs().max()) > 1e-3
        stats = port.stats
        assert stats["generated"] == 3 + 2 + 3 and stats["cache_hits"] == 2 + 2 + 3
    eng = SynthesisEngine(model, sched, image_size=16)
    with pytest.raises(ValueError):
        eng.submit(enc[0], 0, 2)
    for bad in (0, True, "some"):
        with pytest.raises(ValueError):
            SynthesisEngine(model, sched, image_size=16, compaction=bad)
