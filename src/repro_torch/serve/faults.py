"""Fault injection, retry policy, and the typed serving-error contract.

A copy of the JAX package's ``serve/faults.py`` (pure Python and numpy):
importing it from there would pull in ``repro.serve`` and jax with it.
The injector fires at the same (site, host, wave) checks as the
reference's for the same schedule and seed.

The paper motivates one-shot FL by client dropout and stragglers (§I);
at serving scale the same failure modes hit the SERVER: a host dies
mid-drain, a device scan hiccups, a store shard goes unreadable.  This
module is the fault-tolerance substrate the rest of ``serve/`` builds
on, in three pieces:

* ``SynthesisError`` hierarchy — every way a request can fail resolves
  to a TYPED error: transient faults (retryable under policy), a lost
  host (handled by failover, never surfaced per-request), and the
  per-request terminal errors (``RequestFailedError``,
  ``UnservedRequestError``) that ``SynthesisFuture`` delivers.

* ``FaultInjector`` — deterministic fault injection for tests, CI
  gates, and chaos drills.  Faults fire at named SITES inside the
  serving stack (``window`` = host-window dispatch, ``scan`` = device
  scan fence, ``store.read``/``store.write`` = shard I/O), triggered
  either by an explicit (site, host, wave) schedule (each entry fires
  once, so retries make progress) or by a seeded per-check probability.
  No wall-clock and no global RNG — the same injectable-clock
  discipline as ``obs.Tracer``, so a fault schedule is perfectly
  reproducible.

* ``RetryPolicy`` — bounded attempts with exponential backoff on an
  INJECTABLE sleep (tests pass a recording stub; nothing in the policy
  reads a clock), plus transient-vs-permanent classification: transient
  errors burn an attempt, permanent errors raise immediately.

The load-bearing property downstream: row noise is keyed by request
identity (``fold_in(drain_key, rid)``), so every recovery action here —
regenerate a quarantined shard, retry a drain — reproduces
bit-identical rows.  Fault tolerance never resamples.  (The port serves
one host; the ``window`` site and ``HostLostError`` belong to placed
drains, which come with its topology.)
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "SynthesisError", "TransientFaultError", "InjectedFaultError",
    "HostLostError", "AllHostsLostError", "RequestFailedError",
    "UnservedRequestError", "is_transient", "FaultInjector", "RetryPolicy",
]


class SynthesisError(RuntimeError):
    """Base of every typed serving error.  Anything a drain or a future
    raises on purpose is a ``SynthesisError``; a bare exception escaping
    the serving stack is a bug, not a contract."""


class TransientFaultError(SynthesisError):
    """A fault worth retrying: the operation may succeed if re-run
    (flaky I/O, injected transient).  ``RetryPolicy`` burns attempts on
    these and raises everything else immediately."""


class InjectedFaultError(TransientFaultError):
    """A fault raised by ``FaultInjector`` at a non-fatal site."""

    def __init__(self, site: str, host: int = -1, wave: int = -1):
        super().__init__(f"injected fault at site={site!r} "
                         f"host={host} wave={wave}")
        self.site, self.host, self.wave = site, host, wave


class HostLostError(SynthesisError):
    """Host ``host`` died dispatching wave ``wave``.  Not retryable and
    not per-request: the drain handles it by marking the host failed and
    requeueing its requests onto survivors (``_drain_group_placed``)."""

    def __init__(self, host: int, wave: int = -1):
        super().__init__(f"host {host} lost dispatching wave {wave}")
        self.host, self.wave = host, wave


class AllHostsLostError(SynthesisError):
    """Every host in the topology has failed — there is no survivor to
    requeue onto, so the drain cannot make progress."""


class RequestFailedError(SynthesisError):
    """Request ``rid`` failed PERMANENTLY this drain (its group's
    sampler raised a non-transient error).  Delivered onto the affected
    ``SynthesisFuture`` only; ``__cause__`` carries the original
    exception."""

    def __init__(self, message: str, *, rid: int):
        super().__init__(message)
        self.rid = rid


class UnservedRequestError(SynthesisError):
    """A future's drain completed without producing rows or a failure
    for this request — the engine was drained without the service's
    delivery hook.  Re-submit through the service."""


def is_transient(exc: BaseException) -> bool:
    """Default transient-vs-permanent classifier: injected/transient
    faults and OS-level I/O errors (except a plain missing file, which
    is a deterministic cache miss) are worth retrying."""
    if isinstance(exc, TransientFaultError):
        return True
    if isinstance(exc, FileNotFoundError):
        return False
    return isinstance(exc, OSError)


#: Sites the serving stack checks.  ``window`` faults model a lost host
#: (fatal for the host, handled by failover); the rest are transient.
FAULT_SITES = ("window", "scan", "store.read", "store.write")


class FaultInjector:
    """Deterministic fault injection at named serving sites.

    Two trigger modes, composable:

    * ``schedule`` — iterable of ``(site, host, wave)`` triples.
      ``host``/``wave`` may be ``None`` (wildcard).  Each entry fires
      exactly ONCE (first matching check), so a retried operation makes
      progress and a failover's replacement wave is not re-killed by the
      same entry.
    * ``p``/``seed`` — every check draws from a PRIVATE stream keyed by
      ``(seed, site, host, wave, occurrence)`` and fires with
      probability ``p``.  No global RNG, no wall-clock, and the draw
      depends only on WHAT is checked, never on the order checks arrive
      — so whether any given check WOULD fire is reproducible even when
      the engine's per-host drain workers hit sites concurrently in
      scheduler-dependent order.

    ``max_faults`` caps total fires across both modes.  The cap is the
    one arrival-ordered piece of p-mode: slots are claimed first-come,
    so under concurrent workers WHICH candidate fault wins a scarce
    slot can vary with thread interleaving (the served bytes are
    bit-identical either way — failover requeues, never resamples).
    Sequential drains (``workers=False``) reproduce the full ``fired``
    sequence exactly.  ``check`` raises
    ``HostLostError`` for the ``window`` site and ``InjectedFaultError``
    (transient) for every other site; ``fired`` records what actually
    fired, in order.

    ``check`` is THREAD-SAFE (one internal lock over the schedule, the
    per-key occurrence counts, and ``fired``): fault sites fire inside
    per-host workers once drains are concurrent, and a torn
    ``del self._schedule[i]`` would double-fire a one-shot entry.
    """

    def __init__(self, schedule=(), *, p: float = 0.0, seed: int = 0,
                 max_faults: int | None = None):
        norm = []
        for entry in schedule:
            site, host, wave = entry
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}: "
                                 f"sites are {FAULT_SITES}")
            norm.append([site, host, wave])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability p={p} must be in [0, 1]")
        self._schedule = norm            # entries removed as they fire
        self.p = float(p)
        self._seed = int(seed)
        self._counts: dict[tuple, int] = {}   # (site,host,wave) -> checks
        self._lock = threading.Lock()
        self.max_faults = max_faults
        self.fired: list = []            # (site, host, wave) in fire order

    def _capped(self) -> bool:
        return self.max_faults is not None and \
            len(self.fired) >= self.max_faults

    def _draw(self, site: str, host: int, wave: int) -> float:
        """One uniform draw keyed by the CHECK's identity (plus how many
        times this exact site/host/wave was checked before — retries see
        fresh draws), not by arrival order."""
        key = (site, int(host), int(wave))
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        seq = np.random.SeedSequence(
            [self._seed, FAULT_SITES.index(site),
             int(host) + 2, int(wave) + 2, n])
        return float(np.random.default_rng(seq).random())

    def check(self, site: str, *, host: int = -1, wave: int = -1) -> None:
        """Raise if a fault is due at this site, else return.  Called by
        the engine/store at each injectable site; a no-op (beyond one
        schedule scan / RNG draw) when nothing matches."""
        with self._lock:
            due = False
            if not self._capped():
                for i, (s, h, w) in enumerate(self._schedule):
                    if s == site and (h is None or h == host) \
                            and (w is None or w == wave):
                        del self._schedule[i]
                        due = True
                        break
                if not due and self.p > 0.0 and \
                        self._draw(site, host, wave) < self.p:
                    due = True
            if not due:
                return
            self.fired.append((site, host, wave))
        if site == "window":
            raise HostLostError(host, wave)
        raise InjectedFaultError(site, host, wave)

    @property
    def pending(self) -> int:
        """Scheduled entries that have not fired yet."""
        return len(self._schedule)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff on an injectable sleep.

    ``max_attempts`` counts the first try; backoff before retry ``i``
    (0-based) is ``min(base_delay * multiplier**i, max_delay)`` seconds,
    delivered through ``sleep`` (default ``time.sleep``; tests inject a
    recorder — the policy itself never reads a clock).  ``run`` retries
    only errors the classifier calls transient; permanent errors and
    exhausted retries re-raise the original exception.
    """
    max_attempts: int = 3
    base_delay: float = 0.001
    multiplier: float = 2.0
    max_delay: float = 0.1
    sleep: object = field(default=time.sleep, compare=False, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts={self.max_attempts} must be >= 1")
        if self.base_delay < 0 or self.max_delay < 0 or self.multiplier < 1:
            raise ValueError("backoff: need base_delay/max_delay >= 0 and "
                             "multiplier >= 1")

    def delay(self, retry: int) -> float:
        """Backoff before 0-based retry number ``retry``."""
        return min(self.base_delay * self.multiplier ** retry, self.max_delay)

    def run(self, fn, *, classify=is_transient, metrics=None,
            site: str = "op"):
        """Call ``fn`` until it succeeds, a permanent error raises, or
        attempts are exhausted.  ``metrics`` (a ``MetricsRegistry``)
        gets ``retry.attempts``/``retry.exhausted`` counters and a
        ``retry.backoff_s`` histogram, labelled by ``site``."""
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as exc:
                if not classify(exc):
                    raise
                if attempt + 1 >= self.max_attempts:
                    if metrics is not None:
                        metrics.inc("retry.exhausted", site=site)
                    raise
                d = self.delay(attempt)
                if metrics is not None:
                    metrics.inc("retry.attempts", site=site)
                    metrics.observe("retry.backoff_s", d, site=site)
                self.sleep(d)
