"""SynthesisService — the streaming front door to the SynthesisEngine.

The JAX package's ``serve/service.py`` for the port: the same futures,
locks, drain-key stream, store budget and placed drains.  Rows come back
as torch tensors on the model's device.

Where ``SynthesisEngine`` is the wave scheduler (pack → sample → scatter),
the service is the request-lifecycle layer the OSCAR server and the
DM-assisted baselines actually talk to:

* ``submit*`` returns a ``SynthesisFuture`` immediately; ``result()``
  drains on demand, so callers no longer choreograph submit/run phases;
* drains are STREAMING: a ``poll`` callback (or another thread calling
  ``submit`` mid-drain, which touches host-side queues only) feeds
  late-arriving requests into the engine's
  live group queues, where they fill partially-empty open waves instead
  of padding — see ``SynthesisEngine.run``.  Thread submissions are
  folded in at each wave boundary while waves remain in flight; only a
  ``poll`` can keep a drain alive waiting for arrivals;
* a persistent ``SynthesisStore`` can be attached so the
  (encoding-hash, guidance, steps) cache survives the process: a cold
  process against a warm store answers the whole workload with zero
  sampler calls and bit-identical D_syn;
* drain keys are a deterministic stream: drain ``i`` uses
  ``fold_in(base_key, i)``, so a service constructed with the same seed
  and fed the same arrival trace reproduces its outputs exactly.

Thread-safety: ``submit`` may be called from any thread (including while
a drain is running — that is the streaming path); ``drain`` itself is
serialized on an internal lock.  A ``poll`` callback runs on the
draining thread and may submit freely.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.obs.trace import Tracer
from repro_torch.serve.faults import (FaultInjector, RetryPolicy,
                                      SynthesisError, UnservedRequestError)
from repro_torch.serve.store import SynthesisStore
from repro_torch.serve.synthesis import SynthesisEngine


class SynthesisFuture:
    """Handle for one submitted request.  ``result()`` drains the queue
    if needed.  Rows are delivered straight onto the future (the service
    only holds a weak reference), so a long-lived service accumulates
    nothing: discard the future and its images are collectable.

    A future resolves to rows OR to a typed ``SynthesisError``
    (``serve/faults.py``) — never silently to nothing: ``result()``
    raises the stored error, ``exception()`` returns it, and a drain
    that somehow bypassed delivery raises ``UnservedRequestError``."""

    def __init__(self, service: "SynthesisService", rid: int):
        self._service = service
        self._value: Optional[torch.Tensor] = None
        self._error: Optional[SynthesisError] = None
        self.rid = rid

    def done(self) -> bool:
        return self._value is not None or self._error is not None

    def result(self) -> torch.Tensor:
        if not self.done():
            self._service.drain()
        if self._error is not None:
            raise self._error
        if self._value is None:
            raise UnservedRequestError(
                f"request {self.rid} was not served by the drain — "
                "was the service's engine drained directly?")
        return self._value

    def exception(self) -> Optional[SynthesisError]:
        """The typed error this request resolved to, or None if it
        produced rows.  Drains (once) if the request is still pending,
        mirroring ``result()``."""
        if not self.done():
            self._service.drain()
        return self._error

    def __repr__(self):
        state = ("failed" if self._error is not None
                 else "done" if self._value is not None else "pending")
        return f"SynthesisFuture(rid={self.rid}, {state})"


class SynthesisService:
    """Futures + streaming drains + persistent store over one engine."""

    def __init__(self, engine: SynthesisEngine, *,
                 key: np.ndarray | int | None = None,
                 store: SynthesisStore | str | None = None,
                 topology=None, hosts: int | None = None,
                 store_max_bytes: int | None = None,
                 tracer: Tracer | None = None,
                 faults: FaultInjector | None = None,
                 retry: RetryPolicy | None = None):
        """``store`` (a ``SynthesisStore`` or its root) becomes the
        engine's; the engine's own knobs (ragged waves, compaction) are set
        on the engine.

        ``topology`` (a ``serve/topology.py::HostTopology``) or ``hosts``
        (an int H) places drains over hosts: per-host ingress queues,
        per-host windows of each wave against one wave-resident table,
        per-host stats.  Opt-in only, like the other knobs.

        ``store_max_bytes`` is the persistent store's size budget: after
        every drain the least-recently-used shards are evicted until the
        store fits (a long-lived server stops growing without bound).

        ``tracer`` (an ``obs/trace.py::Tracer``) records every drain's
        span timeline and request lifecycle; the service derives
        ``request.queue_wait`` / ``request.e2e_latency`` histograms from
        the stamps after each drain.  Opt-in only, like the other knobs.

        ``faults`` / ``retry`` (``serve/faults.py``) thread a fault
        injector and a retry policy through the engine and its store —
        transient faults retry and permanent failures resolve the
        affected futures to typed errors.  Opt-in
        only, like the other knobs.

        ``key`` (a threefry key, or an int seed) starts the drain-key
        stream.
        """
        if store is not None and not isinstance(store, SynthesisStore):
            store = SynthesisStore(store)
        if store is not None:
            engine.store = store
        engine.opt_in(topology=topology, hosts=hosts, tracer=tracer,
                      faults=faults, retry=retry)
        self.engine = engine
        self.store = engine.store
        self.store_max_bytes = store_max_bytes
        self._evicted_entries = 0
        self._observed: set[int] = set()   # rids whose latencies are recorded
        if key is None:
            key = prng.PRNGKey(0)
        elif isinstance(key, int):
            key = prng.PRNGKey(key)
        self._base_key = np.asarray(key, np.uint32)
        self._drain_i = 0
        # rid -> future, weakly: a discarded future (callers consuming
        # drain()'s return map instead) costs no retained images
        self._futures: "weakref.WeakValueDictionary[int, SynthesisFuture]" \
            = weakref.WeakValueDictionary()
        self._drain_lock = threading.Lock()    # one drain at a time
        self._submit_lock = threading.Lock()   # rid assignment atomicity

    # -- submission (any thread) ------------------------------------------
    def _register(self, rid: int) -> SynthesisFuture:
        fut = SynthesisFuture(self, rid)
        self._futures[rid] = fut
        return fut

    def _deliver(self, rid: int, rows: torch.Tensor):
        fut = self._futures.get(rid)
        if fut is not None:
            fut._value = rows

    def _deliver_error(self, rid: int, err: Exception):
        fut = self._futures.get(rid)
        if fut is not None:
            fut._error = err

    def submit(self, encoding, category: int, count: int | None = None, *,
               guidance: float | None = None,
               num_steps: int | None = None) -> SynthesisFuture:
        with self._submit_lock:
            rid = self.engine.submit(encoding, category, count,
                                     guidance=guidance, num_steps=num_steps)
            return self._register(rid)

    def submit_classifier_guided(self, logprob_fn, category: int, count: int,
                                 *, guidance: float | None = None,
                                 num_steps: int | None = None,
                                 group: Any = None) -> SynthesisFuture:
        with self._submit_lock:
            rid = self.engine.submit_classifier_guided(
                logprob_fn, category, count, guidance=guidance,
                num_steps=num_steps, group=group)
            return self._register(rid)

    def submit_unconditional(self, count: int, *, category: int = -1,
                             num_steps: int | None = None) -> SynthesisFuture:
        with self._submit_lock:
            rid = self.engine.submit_unconditional(count, category=category,
                                                   num_steps=num_steps)
            return self._register(rid)

    # -- draining ---------------------------------------------------------
    def drain(self, key=None, *, poll: Callable[[], bool] | None = None,
              host_polls: dict[int, Callable[[], bool]] | None = None,
              stream: bool | None = None) -> dict[int, torch.Tensor]:
        """Drain queued requests, resolving their futures.

        ``key`` defaults to the next key in the service's deterministic
        drain-key stream.  ``poll`` is forwarded to the engine: it is
        invoked before each wave is packed and may submit new requests —
        compatible ones join the open wave (return falsy once the arrival
        trace is exhausted, or the drain never concludes).
        ``host_polls`` (the engine must have a topology) adds per-host
        admission hooks on the same contract: every live host's hook runs
        at each wave boundary, a dead host's is dropped; see
        ``SynthesisEngine.run``.

        Failure contract: a PERMANENT failure inside one wave group
        resolves that group's futures to ``RequestFailedError`` (read
        via ``exception()``; ``result()`` raises it) while every other
        group keeps serving — one poisoned request never takes down the
        drain for every tenant.  Transient faults retry and a lost host
        fails over inside the engine, invisibly to futures.
        """
        with self._drain_lock:
            if key is None:
                key = prng.fold_in(self._base_key, self._drain_i)
            self._drain_i += 1
            # futures resolve as each wave retires (the per-drain
            # on_result hook), so requests served before a mid-drain
            # failure stay resolved even though run() raises; the return
            # value is the full drain's rid -> rows map
            try:
                return self.engine.run(key, poll=poll,
                                       host_polls=host_polls, stream=stream,
                                       on_result=self._deliver,
                                       on_error=self._deliver_error)
            finally:
                if (self.store is not None
                        and self.store_max_bytes is not None):
                    self._evicted_entries += len(
                        self.store.evict(self.store_max_bytes))
                self._observe_latencies()

    def _observe_latencies(self):
        """Fold each request's lifecycle stamps into the engine's
        ``request.queue_wait`` / ``request.e2e_latency`` histograms —
        once per rid, however many drains or gathers follow."""
        tr, m = self.engine.tracer, self.engine.metrics
        if not tr.enabled:
            return
        for rid in tr.lifecycle:
            if rid in self._observed:
                continue
            lat = tr.request_latency(rid)
            if "e2e_latency" not in lat:
                continue                    # still in flight
            self._observed.add(rid)
            m.observe("request.e2e_latency", lat["e2e_latency"])
            if "queue_wait" in lat:
                m.observe("request.queue_wait", lat["queue_wait"])

    def gather(self, futures: list[SynthesisFuture], key=None, *,
               return_exceptions: bool = False) -> list:
        """Results for ``futures`` in order, draining (once) if needed.
        Queue-wait and end-to-end latency for every request served so
        far land in the engine metrics as ``request.*`` histograms.

        With ``return_exceptions=True`` a failed future contributes its
        typed ``SynthesisError`` instead of raising, so one poisoned
        request doesn't hide every other result."""
        if any(not f.done() for f in futures):
            self.drain(key)
        self._observe_latencies()
        if not return_exceptions:
            return [f.result() for f in futures]
        out = []
        for f in futures:
            err = f.exception()
            out.append(err if err is not None else f.result())
        return out

    @property
    def stats(self) -> dict:
        s = dict(self.engine.stats)
        s["drains"] = self._drain_i
        s["store_entries"] = len(self.store) if self.store is not None else 0
        s["store_evicted"] = self._evicted_entries
        if self.engine.tracer.enabled:
            m = self.engine.metrics
            s["latency"] = {
                "queue_wait": m.get("request.queue_wait", default=None),
                "e2e_latency": m.get("request.e2e_latency", default=None)}
        return s
