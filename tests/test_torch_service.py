"""The port's ``SynthesisService`` and the engine's drain machinery against
the JAX package's, on the 1-layer, d_model 32, 16-px DiT of
``test_torch_engine`` (3 sampling steps, T = 16): futures and gather
order, the drain-key stream, D_syn through both services, repeats and
top-ups through the row cache, streaming against snapshot drains,
double-buffered against synchronous waves, and drains that fail.

D_syn is gated against the reference at 5e-4 (smoke depth, guidance up
to 4.0; ``test_torch_ragged``).  Within the port, a streamed drain that
packs the same waves as a snapshot drain, and a re-drain after a failure,
repeat bit for bit: ragged rows are keyed by identity, and the CPU's
denoiser gives a row the same bits in a wave of the same rows.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import dit as jdit
from repro.diffusion import schedule as jsched
from repro.serve.service import SynthesisService as JService
from repro.serve.store import SynthesisStore as JStore
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.diffusion import schedule as tsched
from repro_torch.serve import (RequestFailedError, SynthesisEngine,
                               SynthesisFuture, SynthesisService,
                               SynthesisStore)
from repro_torch.serve.synthesis import STAT_KEYS
from test_torch_dit import port_model
from torch_one_thread import one_thread  # noqa: F401

TOL = 5e-4
DC = dict(d_model=32, num_layers=1, num_heads=2, train_timesteps=16,
          sample_timesteps=3)


pytestmark = pytest.mark.usefixtures("one_thread")


def jitted_params(jdc, image_size, seed=0, scale=0.05):
    """``test_torch_dit.perturbed_params`` under one ``jax.jit``: the same
    draws within an ulp, in ~2 s instead of ~9 s of eager compiles."""
    def draw():
        params = jdit.init_dit(jax.random.PRNGKey(seed), jdc, image_size, 3)
        leaves, treedef = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        return jax.tree.unflatten(treedef, [
            a + scale * jax.random.normal(k, a.shape, a.dtype)
            for a, k in zip(leaves, keys)])
    return jax.jit(draw)()


def make_server():
    """(reference config, params, schedule, port DiT, port schedule) of
    the 1-layer, d_model 32, 16-px DiT at T = 16."""
    jdc = JDiffusionConfig(**DC)
    params = jitted_params(jdc, 16)
    return (jdc, params, jsched.make_schedule(16), port_model(params, DC, 16),
            tsched.make_schedule(16, device="cpu"))


@pytest.fixture(scope="module")
def server():
    return make_server()


def _enc(seed):
    e = np.random.default_rng(seed).normal(size=(512,))
    return (e / np.linalg.norm(e)).astype(np.float32)


def _port(server, **kw):
    *_, model, sched = server
    eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                          async_waves=kw.pop("async_waves", True),
                          ragged=kw.pop("ragged", False))
    return SynthesisService(eng, **kw)


def _ref(server, **kw):
    jdc, params, jsch, *_ = server
    eng = JEngine(params, jdc, jsch, image_size=16, wave_size=8,
                  ragged=kw.pop("ragged", False))
    return JService(eng, **kw)


def _close(got, want):
    assert got.shape == want.shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


def test_futures_and_gather_match_the_reference_service(server):
    """Futures are pending until a drain; ``gather`` returns rows in
    submission order, D_syn within the gate of the reference service's
    from the same drain key, with the same counters."""
    subs = [(_enc(0), 0, 2, 2.0), (_enc(1), 1, 5, 4.0), (_enc(2), 2, 3, 2.0)]
    port, ref = _port(server, key=3), _ref(server, key=jax.random.PRNGKey(3))
    futs = [port.submit(e, c, n, guidance=g) for e, c, n, g in subs]
    jfuts = [ref.submit(e, c, n, guidance=g) for e, c, n, g in subs]
    assert all(isinstance(f, SynthesisFuture) and not f.done()
               for f in futs)
    assert [f.rid for f in futs] == [f.rid for f in jfuts] == [0, 1, 2]
    first = futs[1].result()                       # drains everything
    assert all(f.done() for f in futs) and port.stats["drains"] == 1
    outs, want = port.gather(futs), ref.gather(jfuts)
    assert [o.shape[0] for o in outs] == [2, 5, 3]
    assert outs[1] is first and port.stats["drains"] == 1
    for o, w in zip(outs, want):
        _close(o, w)
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: ref.stats[k] for k in STAT_KEYS}
    assert port.stats["store_entries"] == port.stats["store_evicted"] == 0


def test_drain_key_stream_is_jax_fold_in(server, monkeypatch):
    """Drain i of a service keyed ``key`` runs on ``fold_in(key, i)`` (an
    int seeds ``PRNGKey``; the default is ``PRNGKey(0)``); an explicit
    drain key is used as given and still counts a drain."""
    seen = []
    for key, jkey in ((7, jax.random.PRNGKey(7)), (None, jax.random.PRNGKey(0)),
                      (prng.PRNGKey(9), jax.random.PRNGKey(9))):
        svc = _port(server, key=key)
        monkeypatch.setattr(svc.engine, "run",
                            lambda k, **kw: seen.append(np.asarray(k)) or {})
        seen.clear()
        for _ in range(3):
            svc.drain()
        svc.drain(prng.PRNGKey(42))
        svc.drain()
        want = [jax.random.fold_in(jkey, i) for i in (0, 1, 2, 4)]
        assert [s.tolist() for s in seen[:3] + seen[4:]] == \
            [np.asarray(w).tolist() for w in want]
        assert seen[3].tolist() == np.asarray(jax.random.PRNGKey(42)).tolist()
        assert svc.stats["drains"] == 5


def test_repeats_and_top_ups_through_both_services_and_stores(server,
                                                              tmp_path):
    """Ragged services with stores: a repeat in a later drain is served
    from the first one's rows with no wave, a larger count generates only
    the top-up rows, keyed by their index in the whole request (within the
    gate of the reference's top-up rows, and bit for bit the rows one
    drain of the larger count gives), and both stores end up with the
    same entries."""
    port = _port(server, key=5, ragged=True,
                 store=SynthesisStore(tmp_path / "port"))
    ref = _ref(server, key=jax.random.PRNGKey(5), ragged=True,
               store=JStore(tmp_path / "ref"))
    outs = []
    for counts in ((3, 4), (3, 7)):
        futs = [port.submit(_enc(10 + i), i, n, guidance=2.0)
                for i, n in enumerate(counts)]
        jfuts = [ref.submit(_enc(10 + i), i, n, guidance=2.0)
                 for i, n in enumerate(counts)]
        got, want = port.gather(futs), ref.gather(jfuts)
        for o, w in zip(got, want):
            _close(o, w)
        assert {k: port.stats[k] for k in STAT_KEYS} == \
            {k: ref.stats[k] for k in STAT_KEYS}
        outs.append(got)
    (a, b), (a2, b2) = outs
    assert torch.equal(a2, a) and torch.equal(b2[:4], b)
    stats = port.stats
    assert stats["generated"] == 3 + 4 + 3 and stats["cache_hits"] == 3 + 4
    assert stats["store_entries"] == 2 == len(ref.store)
    # the top-up rows keep their index in the whole request: they are rows
    # 4-6 of a single drain of 7 rows under the top-up's rid and drain key
    one = _port(server, ragged=True)
    for _ in range(3):
        one.submit(_enc(10), 0, 0)                # rids 0-2, no rows
    whole = one.submit(_enc(11), 1, 7, guidance=2.0)
    one.drain(prng.fold_in(prng.PRNGKey(5), 1))
    assert whole.rid == 3 and torch.equal(whole.result()[4:], b2[4:])


def test_streaming_is_snapshot_bit_for_bit_when_ragged(server):
    """Requests streamed in through ``poll`` at wave boundaries give the
    rows a snapshot drain of the same requests gives, bit for bit: ragged
    rows are keyed by identity, and arrivals that keep the queue ahead of
    the packer fill the same waves."""
    subs = [(_enc(20 + i), i % 3, 4, (2.0, 4.0)[i % 2], (3, 2)[i % 3 == 0])
            for i in range(8)]
    snap = _port(server, key=6, ragged=True)
    futs = [snap.submit(e, c, n, guidance=g, num_steps=s)
            for e, c, n, g, s in subs]
    want = snap.gather(futs)
    stream = _port(server, key=6, ragged=True)
    late = list(subs[4:])
    sfuts = [stream.submit(e, c, n, guidance=g, num_steps=s)
             for e, c, n, g, s in subs[:4]]

    def poll():
        if late:
            e, c, n, g, s = late.pop(0)
            sfuts.append(stream.submit(e, c, n, guidance=g, num_steps=s))
        return bool(late)

    stream.drain(poll=poll)
    got = [f.result() for f in sfuts]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st, ss = stream.stats, snap.stats
    assert st["streamed"] == 4 and ss["streamed"] == 0
    assert (st["waves"], st["padded"], st["row_iters_active"]) == \
        (ss["waves"], ss["padded"], ss["row_iters_active"]) == (4, 0, 84)


def test_sync_and_async_waves_bit_identical(server):
    outs = []
    for async_waves in (False, True):
        svc = _port(server, key=9, async_waves=async_waves)
        futs = [svc.submit(_enc(70 + i), i, c)
                for i, c in enumerate((3, 9, 5))]
        outs.append(svc.gather(futs))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_mid_drain_failure_resolves_served_futures(server):
    """A sampler that fails in one group fails only that group's futures
    (``RequestFailedError`` with the cause); the drain returns, the other
    group keeps its rows, and a resubmit is served."""
    svc = _port(server, key=13)
    fa = svc.submit(_enc(90), 0, 4, guidance=1.0)
    fb = svc.submit(_enc(91), 1, 4, guidance=3.0)    # the later group
    eng = svc.engine
    orig, calls = eng._sample_wave, []

    def failing(head, rows, key):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("sampler died mid-drain")
        return orig(head, rows, key)

    eng._sample_wave = failing
    out = svc.drain()
    assert fa.done() and fa.result().shape == (4, 16, 16, 3)
    assert fa.rid in out and fb.rid not in out
    err = fb.exception()
    assert isinstance(err, RequestFailedError) and err.rid == fb.rid
    assert "mid-drain" in str(err.__cause__)
    with pytest.raises(RequestFailedError):
        fb.result()
    assert eng.metrics.get("requests_failed") == 1
    eng._sample_wave = orig
    assert svc.submit(_enc(91), 1, 4, guidance=3.0).result().shape == \
        (4, 16, 16, 3)


def test_exception_then_redrain_carries_rows(server):
    """A drain that raises after some waves retired keeps their rows: the
    next ``run`` returns every request, bit for bit a clean run's, and a
    service retrying resolves its futures through the carried rows."""
    subs = [(_enc(200 + i), i % 3, 7, 4.0) for i in range(4)]

    def engine():
        return _port(server, ragged=True).engine

    clean = engine()
    rids = [clean.submit(e, c, n, guidance=g) for e, c, n, g in subs]
    oracle = clean.run(prng.PRNGKey(5))
    eng = engine()
    svc = SynthesisService(eng, key=2)
    futs = [svc.submit(e, c, n, guidance=g) for e, c, n, g in subs]
    orig, calls = eng._sample_wave_ragged, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:           # waves 1-2 dispatched, wave 1 retired
            raise RuntimeError("sampler died mid-drain")
        return orig(*a, **kw)

    eng._sample_wave_ragged = failing
    with pytest.raises(RuntimeError, match="mid-drain"):
        eng.run(prng.PRNGKey(5))      # the engine alone: futures unserved
    assert 1 <= 4 - len(eng._queue) < 4 and not any(f.done() for f in futs)
    eng._sample_wave_ragged = orig
    out = svc.gather(futs, prng.PRNGKey(5))
    assert [f.rid for f in futs] == rids
    assert all(torch.equal(o, oracle[r]) for o, r in zip(out, rids))


def test_threads_submitting_mid_drain_are_served(server):
    """Eight threads submit while a streaming drain runs (a short switch
    interval interleaves them with it): every request gets its own rid,
    is served once, and its row is the one its identity gives it."""
    svc = _port(server, key=8, ragged=True)
    futs, lock, start = {}, threading.Lock(), threading.Barrier(9)

    def worker(i):
        start.wait(timeout=30)
        for j in range(5):
            f = svc.submit(_enc(300 + 5 * i + j), j % 3, 1, guidance=2.0)
            with lock:
                futs[f.rid] = (f, 300 + 5 * i + j)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        start.wait(timeout=30)
        first = svc.drain(poll=lambda: any(t.is_alive() for t in threads))
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rows = svc.gather([f for f, _ in futs.values()])   # any late arrival
    assert sorted(futs) == list(range(40)) and len(first) >= 1
    assert all(r.shape == (1, 16, 16, 3) for r in rows)
    stats = svc.stats
    assert stats["requests"] == stats["generated"] == 40
    # a row served by the first drain is its identity's: the same rid and
    # encoding alone in a drain of that key give it bit for bit
    rid = max(first)
    one = _port(server, ragged=True)
    for _ in range(rid):
        one.submit(_enc(0), 0, 0)
    alone = one.submit(_enc(futs[rid][1]), 0, 1, guidance=2.0)
    one.drain(prng.fold_in(prng.PRNGKey(8), 0))
    assert torch.equal(alone.result(), first[rid])


def test_placed_drains_are_refused(server):
    """The placed drains' knobs, refused until the port had the topology
    slice, are taken now: ``hosts=``, ``topology=`` and ``mesh=`` build a
    placed engine, ``host_polls`` streams into a placed drain, and no
    knob raises ``NotImplementedError`` (``test_torch_topology`` holds
    these drains against the reference's)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve.topology import HostTopology
    *_, model, sched = server
    mesh = make_serving_mesh(device="cpu")
    for kw, hosts in ((dict(hosts=2), 2),
                      (dict(topology=HostTopology.simulated(3)), 3),
                      (dict(mesh=mesh, hosts=1), 1)):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              **kw)
        assert eng.topology.num_hosts == hosts
    eng = SynthesisEngine(model, sched, image_size=16, wave_size=8, hosts=2)
    fut = []

    def poll():
        if fut:
            return False
        fut.append(eng.submit(_enc(0), 0, 3))
        return True

    out = eng.run(prng.PRNGKey(0), host_polls={1: poll})
    assert out[fut[0]].shape == (3, 16, 16, 3)
    assert sum(p["rows"] for p in eng.stats["per_host"]) == 3


def test_store_budget_evicts_after_each_drain(server, tmp_path):
    """``store_max_bytes`` keeps the store under its budget after every
    drain, least recently used first, as the reference's service does."""
    per = 2 * 16 * 16 * 3 * 4                   # one request of 2 rows
    out = []
    for name, make, store, key in (
            ("port", _port, SynthesisStore, 22),
            ("ref", _ref, JStore, jax.random.PRNGKey(22))):
        svc = make(server, key=key, store_max_bytes=2 * per,
                   store=store(tmp_path / name))
        for i in range(4):
            svc.submit(_enc(400 + i), i % 3, 2).result()
            assert svc.store.total_bytes() <= 2 * per
        out.append((svc.stats["store_entries"], svc.stats["store_evicted"],
                    sorted(svc.store._manifest["entries"])))
    assert out[0] == out[1] and out[0][:2] == (2, 2)
