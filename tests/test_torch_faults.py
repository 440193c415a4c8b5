"""The port's fault handling against the JAX package's: the typed errors
and their transient/permanent split, ``FaultInjector`` firing at the same
checks for one schedule or seed, ``RetryPolicy``'s attempts and backoff
(an injected sleep, no clock), and the engine under faults on the
1-layer, d_model 32, 16-px DiT of ``test_torch_engine``: transient fence
faults retried to the fault-free D_syn bit for bit with the reference's
counters, a poisoned classifier closure failing alone while a healthy
classifier-guided tenant rides mixed waves, and a corrupt store shard
quarantined and regenerated bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import faults as jfaults
from repro.serve.service import SynthesisService as JService
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.serve import (FaultInjector, RequestFailedError,
                               RetryPolicy, SynthesisEngine, SynthesisError,
                               SynthesisService, SynthesisStore)
from repro_torch.serve import faults as tfaults
from test_torch_service import make_server
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 5e-4


@pytest.fixture(scope="module")
def server():
    return make_server()


def _enc(seed):
    e = np.random.default_rng(seed).normal(size=(512,))
    return (e / np.linalg.norm(e)).astype(np.float32)


# -- errors, injector, retry ------------------------------------------------------

def test_error_hierarchy_and_transient_split_are_the_references():
    seen = []
    for mod in (tfaults, jfaults):
        excs = [mod.InjectedFaultError("scan", 1, 2),
                mod.TransientFaultError("x"), mod.HostLostError(3, 4),
                mod.RequestFailedError("x", rid=5), OSError("io"),
                FileNotFoundError("gone"), ValueError("v")]
        seen.append([(type(e).__name__, mod.is_transient(e),
                      isinstance(e, mod.SynthesisError), str(e))
                     for e in excs])
    assert seen[0] == seen[1]
    assert issubclass(tfaults.InjectedFaultError, tfaults.TransientFaultError)
    assert issubclass(tfaults.RequestFailedError, SynthesisError)


def _checks():
    """A fixed sequence of (site, host, wave) checks, retries included."""
    sites = ("scan", "store.read", "store.write", "window")
    return [(sites[i % 4], i % 3, i // 4) for i in range(40)] + \
        [("scan", 0, 1)] * 5


@pytest.mark.parametrize("kw", [
    dict(schedule=[("scan", None, 1), ("window", 2, None),
                   ("store.read", 0, 0), ("scan", 1, None)]),
    dict(p=0.3, seed=7), dict(p=0.5, seed=11, max_faults=4),
    dict(schedule=[("scan", 0, 1)] * 2, p=0.1, seed=3)],
    ids=["schedule", "p", "capped", "both"])
def test_injector_fires_at_the_references_checks(kw):
    fired = []
    for mod in (tfaults, jfaults):
        inj = mod.FaultInjector(**kw)
        out = []
        for site, host, wave in _checks():
            try:
                inj.check(site, host=host, wave=wave)
                out.append(None)
            except mod.SynthesisError as exc:
                out.append((type(exc).__name__, str(exc)))
        fired.append((out, inj.fired, inj.pending))
    assert fired[0] == fired[1]
    assert any(o is not None for o in fired[0][0])
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector([("disk", None, None)])
    with pytest.raises(ValueError, match="probability"):
        FaultInjector(p=1.5)


def test_retry_policy_attempts_and_backoff_are_the_references():
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry
    out = []
    for mod, reg in ((tfaults, MetricsRegistry()), (jfaults, JRegistry())):
        slept = []
        pol = mod.RetryPolicy(max_attempts=4, base_delay=0.01,
                              multiplier=3.0, max_delay=0.05,
                              sleep=slept.append)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise mod.InjectedFaultError("scan")
            return "ok"

        assert pol.run(flaky, metrics=reg, site="device.scan") == "ok"
        with pytest.raises(ValueError):             # permanent: at once
            pol.run(lambda: (_ for _ in ()).throw(ValueError("bad")),
                    metrics=reg)
        with pytest.raises(mod.InjectedFaultError):  # exhausted
            pol.run(lambda: (_ for _ in ()).throw(
                mod.InjectedFaultError("scan")), metrics=reg, site="s")
        out.append((slept, len(calls), reg.as_dict(),
                     [pol.delay(i) for i in range(5)]))
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=0)
    assert out[0] == out[1]
    assert out[0][0] == [0.01, 0.03, 0.01, 0.03, 0.05]


# -- the engine under faults ------------------------------------------------------

def test_transient_fence_faults_retry_to_the_fault_free_dsyn(server):
    """Scheduled ``scan`` faults fire at the wave fence, burn retries and
    leave D_syn bit for bit the fault-free drain's; the fired checks and
    the retry counters are the reference engine's."""
    jdc, params, jsch, model, sched = server
    subs = [(_enc(40 + i), i, (5, 9, 4)[i]) for i in range(3)]
    plan = [("scan", 0, 0), ("scan", 0, 2), ("scan", None, 2)]
    out, counts = [], []
    for faulty in (False, True):
        for mod, eng in (
                (tfaults, SynthesisEngine(model, sched, image_size=16,
                                          wave_size=8)),
                (jfaults, JEngine(params, jdc, jsch, image_size=16,
                                  wave_size=8))):
            if faulty:
                slept = []
                eng.opt_in(faults=mod.FaultInjector(plan),
                           retry=mod.RetryPolicy(sleep=slept.append))
            rids = [eng.submit(e, c, n, guidance=2.0) for e, c, n in subs]
            key = jax.random.PRNGKey(8)
            res = eng.run(np.asarray(key) if mod is tfaults else key)
            out.append([res[r] for r in rids])
            if faulty:
                counts.append((eng.faults.fired, slept, {
                    k: v for k, v in eng.metrics.as_dict().items()
                    if k.startswith(("retry", "fault"))}))
    clean, _, faulty_rows, jfaulty = out
    assert all(torch.equal(a, b) for a, b in zip(clean, faulty_rows))
    assert all(float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL
               for a, b in zip(faulty_rows, jfaulty))
    assert counts[0] == counts[1] and len(counts[0][0]) == 3


def t_center(x, labels):
    return -torch.sum(x ** 2, dim=(1, 2, 3))


def j_center(x, labels):
    return -jnp.sum(x ** 2, axis=(1, 2, 3))


def _tenants(svc, center, poisoned=None):
    futs = [svc.submit(_enc(60), 0, 5, guidance=2.0),
            svc.submit_classifier_guided(center, 1, 6, guidance=1.0,
                                         num_steps=2),
            svc.submit(_enc(61), 2, 4, guidance=4.0)]
    if poisoned is not None:
        futs += [svc.submit_classifier_guided(poisoned, c, 3, num_steps=3)
                 for c in (0, 2)]
    return futs


def test_a_poisoned_classifier_fails_alone(server):
    """On a ragged service a classifier closure that raises is caught at
    admission (the port calls it once on a zero row): its requests
    resolve to ``RequestFailedError`` while a healthy classifier-guided
    tenant rides mixed waves beside classifier-free requests, bit for bit
    as in a drain without the poisoned tenant and within the gate of the
    reference's."""
    jdc, params, jsch, model, sched = server

    def poisoned(x, labels):
        raise ValueError("poisoned classifier closure")

    def port():
        return SynthesisService(SynthesisEngine(
            model, sched, image_size=16, wave_size=8, ragged=True), key=6)

    svc = port()
    futs = _tenants(svc, t_center, poisoned)
    res = svc.gather(futs, return_exceptions=True)
    for f, r in zip(futs[3:], res[3:]):
        assert isinstance(r, RequestFailedError) and r.rid == f.rid
        assert isinstance(r.__cause__, ValueError)
        with pytest.raises(RequestFailedError):
            f.result()
    alone = port()
    want = alone.gather(_tenants(alone, t_center))
    assert all(torch.equal(a, b) for a, b in zip(res[:3], want))
    assert svc.engine.metrics.get("requests_failed") == 2
    assert svc.engine.stats["merged_waves"] == alone.engine.stats[
        "merged_waves"] >= 1
    ref = JService(JEngine(params, jdc, jsch, image_size=16, wave_size=8,
                           ragged=True), key=jax.random.PRNGKey(6))
    jfuts = _tenants(ref, j_center, poisoned)
    jres = ref.gather(jfuts, return_exceptions=True)
    assert [type(r).__name__ for r in jres[3:]] == ["RequestFailedError"] * 2
    for a, b in zip(res[:3], jres[:3]):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL
    with pytest.raises(RequestFailedError):
        svc.gather(futs)


def test_a_corrupt_shard_is_quarantined_and_regenerated(server, tmp_path):
    """A truncated shard never reaches the caller: a cold engine on the
    store quarantines it and regenerates its request, bit for bit the
    rows first drawn (ragged rows are keyed by identity, and each request
    fills its own wave), while the other requests are store hits; a
    transient read fault retries to a hit."""
    *_, model, sched = server

    def drain(**kw):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              ragged=True,
                              store=SynthesisStore(tmp_path / "dsyn"), **kw)
        rids = [eng.submit(_enc(70 + i), i, 8, guidance=2.0)
                for i in range(3)]
        out = eng.run(prng.PRNGKey(9))
        return [out[r] for r in rids], eng

    first, eng = drain()
    assert eng.stats["waves"] == 3 and eng.stats["padded"] == 0
    bad = eng.store._shards / f"{next(iter(eng.store._manifest['entries']))}.npz"
    bad.write_bytes(bad.read_bytes()[:200])
    again, eng = drain()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert eng.stats["waves"] == 1 and eng.stats["store_hits"] == 16
    assert eng.metrics.get("store.quarantined") == 1
    assert (tmp_path / "dsyn" / "quarantine" / bad.name).exists()
    slept = []
    third, eng = drain(faults=FaultInjector([("store.read", None, None)] * 2),
                       retry=RetryPolicy(sleep=slept.append))
    assert eng.stats["waves"] == 0 and len(slept) == 2
    assert all(torch.equal(a, b) for a, b in zip(first, third))
