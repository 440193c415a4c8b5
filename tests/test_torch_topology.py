"""The port's placed multi-host drains against the JAX package's, on the
1-layer, d_model 32, 16-px DiT of ``test_torch_service`` (3 sampling
steps, T = 16): ``HostTopology``, ``WavePlacement`` and ``wave_quotas``
case by case against the reference's; placed drains over H ∈ {1, 2, 4}
hosts, grouped, ragged and compacted, against the reference's placed
drains (D_syn at 5e-4, every counter and per-host counter exactly);
workers on against off; streaming through ``host_polls``; failover; a
warm store; meshes; and ``hosts=`` through the service, ``synthesize``
and ``Experiment``.

Within the port, workers on and off run the same rows at the same shapes
and repeat bit for bit, as does a failover drill replayed.  Everything
else is gated at the port's packing gate (5e-4 at smoke depth): the CPU's
denoiser does not promise a row the same bits in a batch of another size.
"""
import shutil
import sys
import threading
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.core.oscar import synthesize as jsynthesize
from repro.launch import mesh as jmesh
from repro.serve import faults as jfaults
from repro.serve import topology as jtopo
from repro.serve.service import SynthesisService as JService
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.core import experiment as texp
from repro_torch.core.oscar import client_encodings, synthesize
from repro_torch.diffusion.guidance import plan_epochs
from repro_torch.diffusion.sampler import sample_cfg_compacted
from repro_torch.launch import mesh as tmesh
from repro_torch.obs import Tracer, chrome_trace, validate_chrome_trace
from repro_torch.serve import (AllHostsLostError, FaultInjector,
                               SynthesisEngine, SynthesisService,
                               SynthesisStore)
from repro_torch.serve import faults as tfaults
from repro_torch.serve import topology as ttopo
from test_torch_service import _enc, make_server
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 5e-4
# (encoding seed, category, count, guidance, steps): 16 rows at four
# (guidance, steps) pairs, guidance at most 4.0 (test_torch_ragged), two
# step counts (a compacted window's two epochs keep the reference's
# compiles few)
SUBS = [(0, 0, 5, 1.5, 3), (1, 1, 3, 4.0, 1), (2, 2, 6, 1.5, 1),
        (3, 0, 2, 4.0, 3)]
MODES = {"grouped": dict(ragged=False), "ragged": dict(ragged=True),
         "compacted": dict(compaction="full")}


@pytest.fixture(scope="module")
def server():
    return make_server()


def _submit(eng, subs=SUBS):
    return [eng.submit(_enc(e), c, n, guidance=g, num_steps=s)
            for e, c, n, g, s in subs]


def _port(server, **kw):
    *_, model, sched = server
    kw.setdefault("wave_size", 8)
    return SynthesisEngine(model, sched, image_size=16, **kw)


def _ref(server, **kw):
    jdc, params, jsch, *_ = server
    kw.setdefault("wave_size", 8)
    return JEngine(params, jdc, jsch, image_size=16, **kw)


def _drain(eng, key, subs=SUBS, **run):
    rids = _submit(eng, subs)
    out = eng.run(key, **run)
    return [out[r] for r in rids]


def _gate(got, want):
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert a.shape == np.shape(b)
        assert float(np.max(np.abs(a - np.asarray(b)))) < TOL


def _same(a, b):
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- HostTopology / WavePlacement / wave_quotas: case by case --------------

def _topo_cases():
    def quotas(m):
        t = m.HostTopology.simulated(3, granule=4)
        return (t.num_hosts, t.device_counts, t.granules,
                [t.assign(r) for r in range(5)], t.wave_quotas(24),
                t.wave_quotas(2))

    def failed(m):
        t = m.HostTopology(device_counts=(1, 2, 1), granules=(2, 2, 2))
        t2 = t.mark_failed(1)
        return (t.wave_quotas(13), t2.wave_quotas(13), t2.live_hosts,
                [t2.assign(r) for r in range(4)], t2.mark_failed(1) == t2,
                sorted(t2.failed))

    def placement(m, pad_to=None):
        p = m.WavePlacement.plan([3, 0, 5], granules=[4, 4, 4],
                                 pad_to=pad_to)
        return ([(w.host, w.offset, w.rows, w.real) for w in p.windows],
                p.total_rows, p.real_rows, p.padded,
                p.windows[0].span_attrs)

    return {
        "quotas": quotas,
        "failed": failed,
        "placement": placement,
        "placement-pad-to": lambda m: placement(m, pad_to=(8, 8, 8)),
        "bad-hosts-0": lambda m: m.HostTopology.simulated(0),
        "bad-hosts-bool": lambda m: m.HostTopology.simulated(True),
        "bad-hosts-str": lambda m: m.HostTopology.simulated("2"),
        "no-hosts": lambda m: m.HostTopology(device_counts=(),
                                             granules=()),
        "granules-mismatch": lambda m: m.HostTopology(device_counts=(1, 1),
                                                      granules=(1,)),
        "zero-devices": lambda m: m.HostTopology(device_counts=(1, 0),
                                                 granules=(1, 1)),
        "failed-out-of-range": lambda m: m.HostTopology.simulated(
            2).mark_failed(9),
        "all-lost": lambda m: m.HostTopology.simulated(2).mark_failed(
            0).mark_failed(1),
        "plan-mismatch": lambda m: m.WavePlacement.plan([1, 2],
                                                        granules=[1]),
        "gapped": lambda m: m.WavePlacement(windows=(
            m.HostWindow(0, 0, 4, 4), m.HostWindow(1, 8, 4, 4))),
        "window-real": lambda m: m.HostWindow(0, 0, 4, 5),
    }


def _outcome(fn, mod):
    try:
        return ("ok", fn(mod))
    except Exception as exc:                 # noqa: BLE001 (compared)
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("case", sorted(_topo_cases()))
def test_topology_and_placement_match_the_reference(case):
    """The same calls give the same values, or raise the same error with
    the same message (``AllHostsLostError`` the port's own class)."""
    fn = _topo_cases()[case]
    got, want = _outcome(fn, ttopo), _outcome(fn, jtopo)
    assert got == want
    if case == "all-lost":
        with pytest.raises(tfaults.AllHostsLostError):
            fn(ttopo)


# -- placed drains against the reference's ---------------------------------

@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_placed_drain_matches_the_reference(server, hosts, mode):
    """D_syn within the gate of the reference's placed drain from the same
    key, and every counter, per-host counter and wave geometry count
    equal.  Per-host sums equal the global counters."""
    kw = dict(MODES[mode], hosts=hosts)
    port, ref = _port(server, **kw), _ref(server, **kw)
    _gate(_drain(port, prng.PRNGKey(7)),
          _drain(ref, jax.random.PRNGKey(7)))
    s = port.stats
    assert s == ref.stats
    per = s["per_host"]
    assert len(per) == hosts and s["hosts"] == hosts
    assert sum(p["rows"] for p in per) == s["generated"]
    assert sum(p["padded"] for p in per) == s["padded"]
    assert s["scheduled_rows"] == s["generated"] + s["padded"]
    for k in ("row_iters_scheduled", "row_iters_active"):
        assert sum(p[k] for p in per) == s[k]
    assert sum(p["queue_depth_at_start"] for p in per) == 16
    assert s["row_iters_active"] == sum(n * st for *_, n, _, st in SUBS)


@pytest.mark.parametrize("mode", ["ragged", "compacted"])
def test_one_host_equals_the_unplaced_drain_where_geometries_agree(server,
                                                                   mode):
    """H = 1 packs the unplaced ragged drain's waves (one window each at
    offset 0, the same rows at the same shapes), so it repeats it bit for
    bit."""
    key = prng.PRNGKey(8)
    plain = _port(server, **MODES[mode])
    _same(_drain(_port(server, hosts=1, **MODES[mode]), key),
          _drain(plain, key))
    assert plain.traj_shapes and all(
        isinstance(g, tuple) for g in plain.traj_shapes)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_workers_on_equal_workers_off_bit_for_bit(server, mode):
    """With host streams (``workers=True``) the same windows run at the
    same shapes as without: the same bits and the same counters.  One
    thread launches and fences: in every wave each host's window is
    launched, in window order, before any window is fenced."""
    seen = []
    key = prng.PRNGKey(9)
    on = _port(server, hosts=4, **MODES[mode])
    on._sync_hook = lambda site, host, wave: seen.append(
        (wave, site, host, threading.current_thread().name))
    off = _port(server, hosts=4, workers=False, **MODES[mode])
    _same(_drain(on, key), _drain(off, key))
    assert on.stats == off.stats
    assert {t for *_, t in seen} == {threading.current_thread().name}
    waves = sorted({w for w, *_ in seen})
    assert waves == list(range(on.stats["waves"]))
    for wave in waves:
        ev = [(site, h) for w, site, h, _ in seen if w == wave]
        hosts = [h for site, h in ev if site == "dispatch"]
        assert ev == [("dispatch", h) for h in hosts] + [
            ("fence", h) for h in hosts]
        assert hosts == sorted(hosts)


def _window_replay(eng, key):
    """Wrap ``eng``'s placed waves: each window's rows are sampled again
    alone by the unplaced compacted sampler, with the window's own
    activation plan, and kept by row identity (rid, row index)."""
    replay = {}
    inner = eng._sample_wave_placed

    def call(parts_h, placement, k, max_steps, wave=-1):
        for w in placement.windows:
            parts = parts_h[w.host]
            rows = np.concatenate([p.row_block(t, s, eng._null_row)
                                   for p, t, s in parts])
            ids = [(p.req.rid, p.req.count - p.fresh + s + i,
                    p.req.guidance, p.req.num_steps)
                   for p, t, s in parts for i in range(t)]
            pad = w.rows - w.real
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad, 0)])
            ids += [ids[-1]] * pad
            rid, ridx, g, steps = (np.array(c) for c in zip(*ids))
            keys = prng.fold_in(prng.fold_in(np.asarray(k)[None], rid),
                                ridx)
            steps = steps.astype(np.int32)
            x = sample_cfg_compacted(
                eng.model, eng.sched, rows, keys, g.astype(np.float32),
                steps, max_steps=max_steps, image_size=16,
                plan=plan_epochs(steps, max_steps, compaction="full"))
            for i in range(w.real):
                replay[(int(rid[i]), int(ridx[i]))] = x[i]
        return inner(parts_h, placement, k, max_steps, wave=wave)

    eng._sample_wave_placed = call
    return replay


@pytest.mark.parametrize("hosts", [2, 4])
def test_compacted_windows_replay_through_the_unplaced_sampler(server,
                                                               hosts):
    """Every window of a compacted placed drain, sampled again alone by
    ``sample_cfg_compacted`` with the window's own activation plan (the
    same batches), gives the same bits: the placed path adds nothing but
    its layout, the wave table read at ``row_offset`` and the scatter."""
    key = prng.PRNGKey(17)
    eng = _port(server, hosts=hosts, compaction="full")
    replay = _window_replay(eng, key)
    rids = _submit(eng)
    out = eng.run(key)
    for rid in rids:
        want = torch.stack([replay[(rid, i)]
                            for i in range(len(out[rid]))])
        assert torch.equal(out[rid], want)


def test_the_window_specs_decide_each_operands_rows(server, monkeypatch):
    """The windows follow ``wave_window_specs``: with the conditioning rows
    replicated instead of split, every chunk is handed the whole wave's
    rows and the drain fails; with the image rows replicated a window of
    a two-device mesh runs as one chunk on the first device."""
    from repro_torch.serve import synthesis as tsyn
    real = tsyn.wave_window_specs
    key = prng.PRNGKey(18)

    def replicate(name):
        def specs(ax):
            out = dict(real(ax))
            out[name] = (None,) * len(out[name])
            return out
        return specs

    monkeypatch.setattr(tsyn, "wave_window_specs", replicate("cond"))
    with pytest.raises((RuntimeError, ValueError)):
        _drain(_port(server, hosts=2, ragged=True), key)
    cpu = torch.device("cpu")
    two = tmesh.Mesh(np.array([[[cpu], [cpu]]], dtype=object),
                     ("hosts", "data", "model"))
    monkeypatch.setattr(tsyn, "wave_window_specs", replicate("window"))
    eng = _port(server, ragged=True, mesh=two, hosts=1)
    chunks = []
    inner = eng._dispatch_window

    def dispatch(*a):
        out = inner(*a)
        chunks.append(len(out.chunks))
        return out

    eng._dispatch_window = dispatch
    got = _drain(eng, key)
    monkeypatch.setattr(tsyn, "wave_window_specs", real)
    split = _port(server, ragged=True, mesh=two, hosts=1)
    _gate(got, [x.numpy() for x in _drain(split, key)])
    assert chunks and set(chunks) == {1}


def test_host_polls_stream_matches_the_trace_up_front(server):
    """Requests streamed through per-host hooks land on the hosts identity
    routing gives them and serve the rows of the whole trace submitted up
    front; each live hook runs at every wave boundary, a dead host's not
    at all."""
    key = prng.PRNGKey(10)
    upfront = _drain(_port(server, hosts=2, ragged=True), key)
    svc = SynthesisService(_port(server, hosts=2, ragged=True))

    def submit(i):
        e, c, n, g, s = SUBS[i]
        futs[i] = svc.submit(_enc(e), c, n, guidance=g, num_steps=s)

    futs = {}
    submit(0)
    traces = {0: [1, 3], 1: [2]}        # hooks run 0 then 1: rids 1, 2, 3
    calls = {0: 0, 1: 0}

    def hook(h):
        def poll():
            calls[h] += 1
            if traces[h]:
                submit(traces[h].pop(0))
            return bool(traces[0] or traces[1])
        return poll

    svc.drain(key, host_polls={0: hook(0), 1: hook(1)})
    _gate([futs[i].result() for i in range(4)],
          [u.numpy() for u in upfront])
    assert calls[0] == calls[1] > 0 and svc.stats["streamed"] == 3
    eng = svc.engine
    with pytest.raises(ValueError, match="out of range"):
        eng.run(key, host_polls={2: lambda: False})
    with pytest.raises(ValueError, match="requires a topology"):
        _port(server).run(key, host_polls={0: lambda: False})
    eng.topology = eng.topology.mark_failed(1)
    eng.submit(_enc(4), 0, 2)
    eng.run(key, host_polls={0: hook(0), 1: lambda: 1 / 0})


def test_failover_matches_the_reference_and_replays_bit_for_bit(server):
    """``window`` faults kill hosts 1 and 3 at wave 0 of an H = 4 drain
    (two losses in one wave, on two workers): the same hosts fail as in
    the reference, the same rows are requeued, D_syn within the gate of
    the reference's and of the healthy drain, and a replay of the drill
    is the same bits."""
    sched = [("window", 1, 0), ("window", 3, 0)]
    key = prng.PRNGKey(11)
    runs = []
    for _ in range(2):
        eng = _port(server, hosts=4, ragged=True,
                    faults=FaultInjector(list(sched)))
        runs.append((_drain(eng, key), eng))
    ref = _ref(server, hosts=4, ragged=True,
               faults=jfaults.FaultInjector(list(sched)))
    want = _drain(ref, jax.random.PRNGKey(11))
    (got, eng), (again, eng2) = runs
    _same(got, again)
    _gate(got, want)
    _gate(got, [x.numpy() for x in _drain(_port(server, hosts=4,
                                                 ragged=True), key)])
    assert eng.topology.failed == ref.topology.failed == {1, 3}
    for k in ("failover.requeued_rows", "fault.host_lost", "hosts_live"):
        assert eng.metrics.get(k) == ref.metrics.get(k), k
    # every counter but compiled_shapes: the reference's workers launched
    # the aborted wave's healthy windows (compiling their geometry) before
    # the losses surfaced; the port's workers check every host's window
    # fault site before any launch, so the aborted wave leaves none
    drop = lambda st: {k: v for k, v in st.items()    # noqa: E731
                       if k != "compiled_shapes"}
    assert drop(eng.stats) == drop(ref.stats) and eng.stats == eng2.stats
    assert eng.stats["compiled_shapes"] == ref.stats["compiled_shapes"] - 1


def test_all_hosts_lost_keeps_the_queue_and_a_fresh_topology_serves(server):
    key = prng.PRNGKey(12)
    eng = _port(server, hosts=2, ragged=True, faults=FaultInjector(
        [("window", 0, None), ("window", 1, None)]))
    rids = _submit(eng)
    with pytest.raises(AllHostsLostError):
        eng.run(key)
    assert [r.rid for r in eng._queue] == rids
    assert eng.topology.failed == {0}
    # the same fleet re-applied keeps host 0 failed; a fresh one serves
    eng.set_topology(2)
    assert eng.topology.failed == {0}
    eng.topology = ttopo.HostTopology.simulated(2, granule=eng.granule)
    out = eng.run(key)
    assert not eng.topology.failed
    _gate([out[r] for r in rids],
          [x.numpy() for x in _drain(_port(server, ragged=True), key)])


def test_a_warm_store_serves_every_topology_with_no_wave(server, tmp_path):
    key = prng.PRNGKey(13)
    warm = SynthesisService(_port(server, ragged=True),
                            store=SynthesisStore(tmp_path))
    want = warm.gather([warm.submit(_enc(e), c, n, guidance=g, num_steps=s)
                        for e, c, n, g, s in SUBS], key)
    for hosts, mode in ((2, "ragged"), (4, "compacted"), (2, "grouped")):
        cold = SynthesisService(_port(server, hosts=hosts, **MODES[mode]),
                                store=SynthesisStore(tmp_path))
        got = cold.gather([cold.submit(_enc(e), c, n, guidance=g,
                                       num_steps=s)
                           for e, c, n, g, s in SUBS], key)
        assert cold.stats["waves"] == 0 and cold.stats["generated"] == 0
        _same(got, want)


def test_a_one_device_mesh_places_windows_as_the_reference_does(server):
    """``from_mesh``, ``host_mesh`` and the windows' layout on a 1-device
    mesh (the reference's own tests run ``jax.device_count() == 1``); its
    D_syn equals the simulated H = 1 drain's.  A mesh of two data
    devices (the CPU twice) splits every window into two chunks, within
    the gate."""
    mesh = tmesh.make_serving_mesh(hosts=1, data=1, model=1, device="cpu")
    jm = jmesh.make_serving_mesh(hosts=1, data=1, model=1)
    t, jt = (ttopo.HostTopology.from_mesh(mesh),
             jtopo.HostTopology.from_mesh(jm))
    assert (t.device_counts, t.granules) == (jt.device_counts, jt.granules)
    assert t.host_mesh(0).axis_names == jt.host_mesh(0).axis_names \
        == ("data", "model")
    plain = tmesh.make_host_mesh(1, 1, device="cpu")
    pt = ttopo.HostTopology.from_mesh(plain, 1)
    assert pt.host_mesh(0).axis_names == ("data", "model")
    with pytest.raises(ValueError, match="out of range"):
        pt.host_mesh(1)
    with pytest.raises(ValueError, match="hosts must divide"):
        ttopo.HostTopology.from_mesh(plain, 2)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_serving_mesh(hosts=2, device="cpu")
    assert ttopo.HostTopology.simulated(2).host_mesh(0) is None
    key = prng.PRNGKey(14)
    eng = _port(server, ragged=True, mesh=mesh, hosts=1)
    assert eng.topology.mesh is mesh
    sh = eng._window_shardings(0)
    assert sh["y"].mesh.axis_names == ("data", "model")
    assert sh["y"].split and not sh["ab_t"].split
    assert sh["y"].devices == (torch.device("cpu"),)
    got = _drain(eng, key)
    _same(got, _drain(_port(server, ragged=True, hosts=1), key))
    cpu = torch.device("cpu")
    two = tmesh.Mesh(np.array([[[cpu], [cpu]]], dtype=object),
                     ("hosts", "data", "model"))
    for kw in (dict(hosts=1), {}):
        eng2 = _port(server, compaction="full", mesh=two, **kw)
        assert eng2.granule == 8 and tmesh.data_devices(two) == (cpu, cpu)
        _gate(_drain(eng2, key), [x.numpy() for x in got])


def test_placed_knobs_thread_through_service_synthesize_and_opt_in(server):
    """``SynthesisService(hosts=)`` against the reference's; ``hosts=``
    through ``synthesize``; opt-in only: a re-applied equal topology keeps
    the per-host counters and does not bring a failed host back."""
    jdc, params, jsch, model, sched = server
    key = prng.PRNGKey(15)
    svc = SynthesisService(_port(server, ragged=True), hosts=2)
    jsvc = JService(_ref(server, ragged=True), hosts=2)
    got = svc.gather([svc.submit(_enc(e), c, n, guidance=g, num_steps=s)
                      for e, c, n, g, s in SUBS], key)
    want = jsvc.gather([jsvc.submit(_enc(e), c, n, guidance=g, num_steps=s)
                        for e, c, n, g, s in SUBS], jax.random.PRNGKey(15))
    _gate(got, want)
    eng = svc.engine
    assert eng.stats["per_host"] == jsvc.engine.stats["per_host"]
    rows = [p["rows"] for p in eng.stats["per_host"]]
    eng.topology = eng.topology.mark_failed(1)
    SynthesisService(eng, hosts=2)
    eng.opt_in(hosts=2)
    assert [p["rows"] for p in eng.stats["per_host"]] == rows
    assert eng.topology.failed == {1}
    eng.set_topology(3)
    assert eng.topology.num_hosts == 3 and not eng.topology.failed
    with pytest.raises(ValueError, match="topology"):
        eng.set_topology(True)
    enc = np.stack([np.stack([_enc(60 + c) for c in range(3)])])
    present = np.ones((1, 3), bool)
    e2 = _port(server)
    sx, sy = synthesize(key, model, sched, enc, present, 2, image_size=16,
                        engine=e2, hosts=2)
    jx, _ = jsynthesize(jax.random.PRNGKey(15), params, jdc, jsch, enc,
                        present, 2, image_size=16, hosts=2, wave_size=8)
    _gate([sx], [jx])
    assert e2.topology.num_hosts == 2 and sy.tolist() == [0, 0, 1, 1, 2, 2]
    assert sum(p["rows"] for p in e2.stats["per_host"]) == 6


def test_experiment_places_its_shared_service(tmp_path):
    """``Experiment(hosts=2)`` builds its shared engine over two simulated
    hosts, and OSCAR's D_syn through it is ``synthesize``'s at
    ``hosts=2`` from the same key and DM, bit for bit."""
    from test_torch_experiment import TINY, _cfg
    from repro_torch.configs import oscar as tconfigs
    exp = texp.Experiment(_cfg(tconfigs, TINY), verbose=False,
                          cache_dir=tmp_path, device="cpu", hosts=2)
    assert exp.engine.topology.num_hosts == 2
    kept = {}
    real = texp.run_oscar

    def run_oscar(*args, **kwargs):
        res = real(*args, **kwargs)
        kept["x"] = res.syn_images
        return res

    texp.run_oscar = run_oscar
    try:
        out = exp.run("oscar")
    finally:
        texp.run_oscar = real
    assert 0.0 <= out["avg"] <= 1.0
    s = exp.engine.stats
    assert sum(p["rows"] for p in s["per_host"]) == s["generated"] > 0
    ksyn = prng.split(prng.fold_in(exp.key, zlib.crc32(b"oscar")), 3)[1]
    enc, present = client_encodings(exp.fm, exp.data, device="cpu")
    x, _ = synthesize(ksyn, exp.dm, exp.sched, enc, present,
                      exp.ocfg.samples_per_category, image_size=16,
                      engine=SynthesisEngine(exp.dm, exp.sched,
                                             image_size=16, hosts=2))
    _same([x], [kept["x"]])
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_a_placed_drain_traces_one_track_per_host(server):
    tracer = Tracer()
    eng = _port(server, hosts=2, ragged=True, tracer=tracer)
    _drain(eng, prng.PRNGKey(16))
    obj = chrome_trace(tracer, hosts=2)
    assert validate_chrome_trace(obj, require_hosts=2) > 0
    names = {sp.name for sp in tracer.spans}
    assert {"window.pack", "window.dispatch", "segment.dispatch",
            "device.scan"} <= names


def test_launch_counters_lose_no_count_under_threads():
    """``build.count_launch`` from more threads than cores, the interpreter
    switching threads every microsecond: no count is lost."""
    from repro_torch.kernels.build import count_launch

    def fn():
        pass

    fn.launches = fn.launches_offset = 0
    n, per = 32, 20000
    go = threading.Barrier(n)

    def work():
        go.wait(timeout=30)
        for i in range(per):
            count_launch(fn, "launches", *(("launches_offset",) if i % 2
                                           else ()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (fn.launches, fn.launches_offset) == (n * per, n * per // 2)
