"""The port's tracer and trace export against the JAX package's: one
``FakeClock`` script through both tracers gives equal spans, lifecycle
stamps, latencies and chrome-trace JSON; both validators refuse the same
malformed traces; a drain records the reference's spans (names,
attributes, nesting) and lifecycle stages, and the port's own
(``PORT_ONLY``) where they belong; and tracing never changes
D_syn (bit for bit on and off).  The drains run on the 1-layer,
d_model 32, 16-px DiT of ``test_torch_engine``."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import trace as jtrace
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve.service import SynthesisService as JService
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch.obs import (FakeClock, MetricsRegistry, Tracer,
                             chrome_trace, metrics_json,
                             validate_chrome_trace, write_trace)
from repro_torch.obs import trace as ttrace
from repro_torch.serve import SynthesisEngine, SynthesisService
from test_torch_service import make_server
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def server():
    return make_server()


def _script(mod, registry):
    """Spans (nested, attributes set while open, one closed by an
    exception), instants, lifecycle stamps (first wins, a backdated one)
    and histogram observations, on a ticking fake clock."""
    clock = mod.FakeClock(start=1.5, tick=0.25)
    tr = mod.Tracer(clock=clock)
    with tr.span("drain", queued=3):
        with tr.span("wave.pack", wave=0, host=0) as sp:
            sp.set(rows=8, real=7)
        tr.instant("store.quarantine", track="store", slug="ab")
        with tr.span("store.read", track="store", slug="cd"):
            clock.advance(0.125)
        try:
            with tr.span("device.scan", host=1, rows=8):
                raise RuntimeError("fence")
        except RuntimeError:
            pass
    for rid in range(3):
        tr.stamp(rid, "admit")
        tr.stamp(rid, "enqueue")
        tr.stamp(rid, "dispatch", t=tr.now())
        tr.stamp(rid, "dispatch")                # the first one wins
        if rid != 1:
            tr.stamp(rid, "deliver")
    with pytest.raises(ValueError, match="lifecycle stage"):
        tr.stamp(0, "teleport")
    for v in (1e-4, 2e-3, 0.5, 0.5, 3.0):
        registry.observe("request.e2e_latency", v)
    registry.inc("waves", 4)
    registry.inc("host.rows", 7, host=1)
    registry.set_gauge("hosts", 2)
    return tr


def test_the_same_script_gives_the_references_spans_and_trace(tmp_path):
    jtr = _script(jtrace, jreg := JRegistry())
    ttr = _script(ttrace, treg := MetricsRegistry())
    span = lambda s: (s.name, s.start, s.duration, s.attrs, s.depth)
    assert [span(s) for s in ttr.spans] == [span(s) for s in jtr.spans]
    assert ttr.lifecycle == jtr.lifecycle
    for rid in range(3):
        assert ttr.request_latency(rid) == jtr.request_latency(rid)
    assert ttr.request_latency(9) == {} and "e2e_latency" not in \
        ttr.request_latency(1)
    for hosts in (None, 3):
        assert chrome_trace(ttr, hosts=hosts) == \
            jexport.chrome_trace(jtr, hosts=hosts)
    assert metrics_json(treg) == jexport.metrics_json(jreg)
    obj = write_trace(tmp_path / "t.json", ttr, registry=treg, hosts=2)
    want = jexport.write_trace(tmp_path / "j.json", jtr, registry=jreg,
                               hosts=2)
    assert obj == want
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert validate_chrome_trace(json.loads(
        (tmp_path / "t.json").read_text())) == len(obj["traceEvents"])
    off = Tracer(enabled=False)
    assert off.span("x", a=1) is ttrace.NULL_SPAN and off.now() is None
    off.stamp(0, "admit")
    off.instant("x")
    assert off.spans == [] and off.lifecycle == {}


def _good():
    return {"traceEvents": [
        {"ph": "M", "pid": 0, "tid": 1, "ts": 0, "name": "thread_name",
         "args": {"name": "host 0"}},
        {"ph": "X", "pid": 0, "tid": 1, "ts": 10.0, "dur": 5.0,
         "name": "wave.pack", "args": {}}]}


def _broken():
    bad = []
    t = _good()
    del t["traceEvents"][1]["dur"]
    bad.append((t, None))
    t = _good()
    t["traceEvents"][1]["ts"] = -1
    bad.append((t, None))
    t = _good()
    t["traceEvents"][1]["dur"] = "long"
    bad.append((t, None))
    t = _good()
    del t["traceEvents"][0]["pid"]
    bad.append((t, None))
    bad.append(({"traceEvents": []}, None))
    bad.append(({"traceEvents": [_good()["traceEvents"][0]]}, None))
    bad.append((_good(), 2))                     # a host track missing
    return bad


@pytest.mark.parametrize("case", range(7))
def test_malformed_traces_are_refused_as_the_reference_refuses(case):
    obj, hosts = _broken()[case]
    with pytest.raises(ValueError) as got:
        validate_chrome_trace(obj, require_hosts=hosts)
    with pytest.raises(ValueError) as want:
        jexport.validate_chrome_trace(obj, require_hosts=hosts)
    assert str(got.value) == str(want.value)
    assert validate_chrome_trace(_good(), require_hosts=1) == 2


def _enc(seed):
    e = np.random.default_rng(seed).normal(size=(512,))
    return (e / np.linalg.norm(e)).astype(np.float32)


SUBS = [(_enc(30 + i), i, (3, 6, 5)[i], (2.0, 4.0, 2.0)[i])
        for i in range(3)]
#: spans the port records and the reference does not
PORT_ONLY = {"wave.admit", "wave.device", "flash_attention"}


def _drain(svc):
    futs = [svc.submit(e, c, n, guidance=g) for e, c, n, g in SUBS]
    return svc.gather(futs)


@pytest.mark.parametrize("ragged", [False, True], ids=["grouped", "ragged"])
def test_a_drain_records_the_references_spans_and_leaves_dsyn_alone(
        server, ragged):
    jdc, params, jsch, model, sched = server
    traced = Tracer(clock=FakeClock(tick=1e-3))
    jtraced = jtrace.Tracer(clock=jtrace.FakeClock(tick=1e-3))
    svc = SynthesisService(SynthesisEngine(model, sched, image_size=16,
                                           wave_size=8, ragged=ragged),
                           key=4, tracer=traced)
    ref = JService(JEngine(params, jdc, jsch, image_size=16, wave_size=8,
                           ragged=ragged), key=jax.random.PRNGKey(4),
                   tracer=jtraced)
    on = _drain(svc)
    _drain(ref)
    off = _drain(SynthesisService(SynthesisEngine(
        model, sched, image_size=16, wave_size=8, ragged=ragged), key=4))
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    shape = lambda tr: [(s.name, s.attrs, s.depth) for s in tr.spans
                        if s.name not in PORT_ONLY]
    assert shape(traced) == shape(jtraced)
    assert not PORT_ONLY & {s.name for s in jtraced.spans}
    # the port's own: a ``wave.admit`` closes just before each wave's
    # ``wave.pack``, its sibling (one more ends each group's drain), the
    # DiT's attention calls nest in their wave's dispatch, and no
    # ``wave.device`` on the CPU
    spans = traced.spans
    packs = [i for i, s in enumerate(spans) if s.name == "wave.pack"]
    groups = 1 if ragged else len({g for *_, g in SUBS})
    assert sum(s.name == "wave.admit" for s in spans) == len(packs) + groups
    for i in packs:
        a, p = spans[i - 1], spans[i]
        assert (a.name, a.attrs, a.depth) == \
            ("wave.admit", {"wave": p.attrs["wave"]}, p.depth)
        assert a.end <= p.start
    dispatches = [s for s in spans if s.name == "wave.dispatch"]
    calls = [s for s in spans if s.name == "flash_attention"]
    dc = model.dc
    assert len(calls) == len(dispatches) * dc.num_layers * \
        dc.sample_timesteps
    for c in calls:
        assert sum(d.start < c.start and c.end < d.end
                   and c.depth == d.depth + 1 for d in dispatches) == 1
    assert "wave.device" not in {s.name for s in spans}
    assert {k: sorted(v) for k, v in traced.lifecycle.items()} == \
        {k: sorted(v) for k, v in jtraced.lifecycle.items()}
    for rid, st in traced.lifecycle.items():
        order = [st[s] for s in ttrace.LIFECYCLE_STAGES if s in st]
        assert order == sorted(order)
    lat = svc.stats["latency"]
    assert lat["e2e_latency"]["count"] == lat["queue_wait"]["count"] == 3
    assert validate_chrome_trace(chrome_trace(traced)) > 0
