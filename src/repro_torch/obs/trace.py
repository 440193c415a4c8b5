"""Span tracing for the serving stack.

A copy of the JAX package's ``obs/trace.py`` (pure Python): importing it
from there would pull in ``repro.obs`` and jax with it.

``Tracer`` records NESTABLE SPANS — named intervals with a monotonic
start, a duration, and structured attributes — plus per-request
LIFECYCLE STAMPS, so a drain's timeline (packing, dispatch, fenced
device scans, store I/O) and every request's queue-wait / end-to-end
latency fall out of one object:

* ``with tracer.span("wave.sample", host=h, wave=k): ...`` opens a span;
  nesting is tracked (``Span.depth``), attributes may be added while the
  span is open via ``.set(...)``, and the clock is INJECTABLE — tests run
  drains under a ``FakeClock`` and assert exact timings;
* ``tracer.stamp(rid, "admit")`` stamps one stage of a request's
  lifecycle (``admit → enqueue → pack → dispatch → retire → deliver``;
  first stamp per (rid, stage) wins, so a request whose rows span
  several waves keeps its FIRST pack/dispatch);
  ``tracer.request_latency(rid)`` derives ``queue_wait``
  (enqueue → dispatch) and ``e2e_latency`` (admit → deliver) from them;
* a DISABLED tracer (``Tracer(enabled=False)``; ``default()`` until
  enabled) is near-zero cost: ``span()`` returns one shared no-op context
  manager and ``stamp`` returns immediately — nothing is recorded, no
  clock is read, and the serving hot path stays untimed.

Tracing NEVER touches computation: spans and stamps observe the drain,
they do not key noise, schedule waves, or order anything — D_syn is
bit-identical with tracing on or off (gated in ``tests/test_torch_obs.py``
and ``chip_smoke.py`` phase 11.5).

THREAD-SAFETY: the engine's per-host drain workers open spans and stamp
lifecycles concurrently.  Span NESTING is tracked per thread (each
thread sees its own depth stack — a worker's ``device.scan`` nests
under whatever that worker opened, never under another host's span),
while the closed-span buffer and the lifecycle stamps are guarded by
one lock so no record is lost.  The disabled path is untouched:
``span()`` still returns the shared no-op and ``stamp`` still returns
before reading any clock or taking any lock.

THE PROFILER'S CLOCK (port only): while a tracer is enabled and a
``torch.profiler`` session records, every span also opens a
``torch.profiler.record_function`` of its name, so the span sits on the
profiler's host timeline with a device-side range over the work launched
inside it (``gpu_user_annotation``), and an idle gap of the card is named
by the innermost span open over it.  A disabled tracer makes no torch
call.

THE CURRENT TRACER (port only): layers below the engines (``models/``,
``diffusion/``, the kernel wrappers) open their spans on ``current()``,
the tracer of the engine whose work runs on the calling thread (an engine
makes its own current with ``using``), or a disabled one with no engine
active.  An engine built without ``tracer=`` records into ``default()``,
the process's tracer, disabled until an operator sets its ``enabled``.
An attribute may be a device tensor (a count the host would have to wait
for); ``resolve`` turns it into a number when the spans are read, after
the work is fenced.

Export to a Perfetto/``chrome://tracing``-loadable timeline lives in
``obs/export.py``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

#: request-lifecycle stages, in order.  ``stamp`` accepts only these.
LIFECYCLE_STAGES = ("admit", "enqueue", "pack", "dispatch", "retire",
                    "deliver")
_STAGE_SET = frozenset(LIFECYCLE_STAGES)


class FakeClock:
    """Deterministic injectable clock: returns a fixed time until
    ``advance``d.  ``tick`` (optional) auto-advances by a fixed step on
    every read, so consecutive spans get distinct, predictable stamps.
    Reads and advances are atomic (its own lock): concurrent drain
    workers reading a ticking clock must not tear the increment."""

    def __init__(self, start: float = 0.0, *, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)
        self._lock = threading.Lock()

    def advance(self, dt: float):
        with self._lock:
            self.t += float(dt)

    def __call__(self) -> float:
        with self._lock:
            now = self.t
            self.t += self.tick
            return now


@dataclass
class Span:
    """One closed span: ``start`` / ``duration`` are seconds on the
    tracer's clock; ``depth`` is the nesting level at open time (0 =
    top-level); ``attrs`` are the structured attributes (``host=`` puts
    the span on that host's track in the exported timeline)."""
    name: str
    start: float
    duration: float
    attrs: dict = field(default_factory=dict)
    depth: int = 0

    @property
    def end(self) -> float:
        return self.start + self.duration


class _NullSpan:
    """Shared no-op context manager — the whole disabled-tracer span
    path is two attribute loads and one call."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _OpenSpan:
    """A span being recorded; closes (and appends to the tracer) on
    ``__exit__``.  Opened while the profiler records, it holds a
    ``record_function`` range of its name over the same interval."""
    __slots__ = ("_tracer", "name", "attrs", "_start", "depth", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack   # this THREAD's nesting stack
        self.depth = len(stack)
        stack.append(self)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._start = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        end = self._tracer.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = self._tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:                            # exited out of order: drop to self
            while stack and stack[-1] is not self:
                stack.pop()
            if stack:
                stack.pop()
        with self._tracer._lock:
            self._tracer.spans.append(Span(self.name, self._start,
                                           max(end - self._start, 0.0),
                                           self.attrs, self.depth))
        return False


class Tracer:
    """Span + request-lifecycle recorder.

    ``clock`` is any zero-arg callable returning seconds on a monotonic
    scale (default ``time.perf_counter``; tests inject ``FakeClock``).
    ``enabled=False`` makes every recording call a near-zero-cost no-op.
    """

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self.spans: list[Span] = []
        self.lifecycle: dict[int, dict[str, float]] = {}
        self._tls = threading.local()    # per-thread nesting stacks
        self._lock = threading.Lock()    # guards spans + lifecycle

    @property
    def _stack(self) -> list:
        """The CALLING thread's open-span stack: nesting depth is a
        per-thread notion (a drain worker's spans nest under what that
        worker opened, not under another host's)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- spans ------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a nestable span: ``with tracer.span("wave.pack", wave=3,
        host=0) as sp: ... sp.set(rows=64)``."""
        if not self.enabled:
            return NULL_SPAN
        return _OpenSpan(self, name, attrs)

    def instant(self, name: str, **attrs):
        """Record a zero-duration marker at the current clock."""
        if not self.enabled:
            return
        span = Span(name, self.clock(), 0.0, attrs, len(self._stack))
        with self._lock:
            self.spans.append(span)

    def now(self) -> Optional[float]:
        """Current clock reading, or None when disabled — how the engine
        captures a timestamp early (e.g. at pack time) to commit as a
        stamp later, once the wave it belongs to actually dispatched."""
        return self.clock() if self.enabled else None

    # -- request lifecycle ------------------------------------------------
    def stamp(self, rid: int, stage: str, t: Optional[float] = None):
        """Stamp one lifecycle stage for request ``rid``.  First stamp
        per (rid, stage) wins — a request whose rows span several waves
        keeps its first pack/dispatch time.  ``t`` (from ``now()``)
        backdates the stamp to a previously captured clock reading, so a
        stage observed mid-wave can be committed only after the wave
        succeeds (an aborted wave must not freeze its stamps)."""
        if not self.enabled:
            return
        if stage not in _STAGE_SET:
            raise ValueError(f"unknown lifecycle stage {stage!r}; expected "
                             f"one of {LIFECYCLE_STAGES}")
        if t is None:
            t = self.clock()
        with self._lock:
            self.lifecycle.setdefault(rid, {}).setdefault(stage, t)

    def request_latency(self, rid: int) -> dict:
        """Derived latencies for ``rid``: ``queue_wait`` (enqueue →
        dispatch — time spent on an ingress queue before any of its rows
        hit a device) and ``e2e_latency`` (admit → deliver).  Missing
        stages (e.g. a pure cache hit never enqueues) simply omit the
        corresponding entry."""
        st = self.lifecycle.get(rid)
        if not st:
            return {}
        out = {}
        if "enqueue" in st and "dispatch" in st:
            out["queue_wait"] = st["dispatch"] - st["enqueue"]
        if "admit" in st and "deliver" in st:
            out["e2e_latency"] = st["deliver"] - st["admit"]
        return out

    # -- management -------------------------------------------------------
    def clear(self):
        self.spans.clear()
        self.lifecycle.clear()
        self._stack.clear()

    def __repr__(self):
        return (f"Tracer(enabled={self.enabled}, spans={len(self.spans)}, "
                f"requests={len(self.lifecycle)})")


def resolve(attrs: dict) -> dict:
    """``attrs`` with each tensor as its number (or list): a read of the
    device, so only after the spans' work is fenced."""
    return {k: (v.tolist() if isinstance(v, torch.Tensor) else v)
            for k, v in attrs.items()}


_DEFAULT = Tracer(enabled=False)
_OFF = Tracer(enabled=False)
_current = threading.local()


def default() -> Tracer:
    """The process's tracer, which an engine built without ``tracer=``
    records into; disabled until an operator sets ``enabled``."""
    return _DEFAULT


def current() -> Tracer:
    """The calling thread's current tracer: the running engine's, else a
    disabled one."""
    return getattr(_current, "tracer", _OFF)


@contextlib.contextmanager
def using(tracer: Tracer):
    """Make ``tracer`` current on this thread for the block."""
    prev = current()
    _current.tracer = tracer
    try:
        yield tracer
    finally:
        _current.tracer = prev
