"""Batched D_syn synthesis: wave-scheduled diffusion sampling, the JAX
package's ``serve/synthesis.py`` over one host.

``SynthesisEngine`` turns queued requests into sampler waves and hands
every request its rows back.  A request is classifier-free (``submit``:
an encoding, paper Eq. 8/9, or one distinct conditioning row per sample
as a 2-D ``(count, cond_dim)`` encoding, FedDISC's resampled statistics),
classifier-guided (``submit_classifier_guided``: a client classifier's
log p(y|x) and a category, Eq. 4 / FedCADO) or unconditional
(``submit_unconditional``: draws through the null embedding).

* Admitted requests wait in LIVE PER-GROUP QUEUES (``_GroupQueue``); the
  packer peels rows off a group's queue one wave at a time, so a request
  admitted mid-drain (``run(poll=...)``, or ``submit`` from another
  thread) fills the open wave instead of forcing padding.  Groups are
  (mode, guidance, steps), classifier-guided ones also by their ``group``
  (one uploaded classifier), or one merged group when the engine is
  ragged; groups drain in sorted order.
* In a snapshot drain (``run`` without ``poll``) a group of N rows is
  packed into near-uniform waves, ``w = ceil(N / ceil(N / wave_size) / 8)
  * 8`` rows, a short last wave padded by repeating its last row (the
  padding is discarded).  A streaming drain packs ``wave_size``-row waves
  and rounds only the tail up to a granule.
* Wave ``i`` of a drain, counted across groups, samples a grouped wave
  from ``fold_in(key, i)``: ``sample_cfg``, ``sample_classifier_guided``
  (the rows' categories are the labels, the group's first request's
  classifier guides) or ``sample_uncond``.  A ragged wave gives every row
  its own (guidance, steps) and noise key ``fold_in(fold_in(key, rid),
  row_index)``, so a row's value does not depend on how it was packed or
  when it arrived; its step ceiling is the running maximum over the
  group's waves.  With ``compaction`` the wave runs as nested activation
  epochs (``plan_epochs``), the rows' values those of the one-shot wave.
  In a ragged wave an unconditional row is a classifier-free row with
  guidance 0 on the null embedding, and a classifier-guided row carries
  the null embedding, its category and a slot in the engine's classifier
  registry (classifiers match by identity); a wave that holds one runs
  ``sample_mixed`` (``cfg_update_mixed``), any other ``sample_cfg_ragged``.
* Waves are DOUBLE-BUFFERED (``async_waves``): wave k+1 is packed and its
  kernels launched while wave k runs on the card; retiring wave k waits
  on a CUDA event recorded after its own work (the ``scan`` fault site
  and the ``device.scan`` span), never on the whole device.
* Rows are cached by (encoding hash, guidance, steps), an unconditional
  request by (``"uncond:<category>"``, 0.0, steps): a repeat is served
  from the first one's rows and a larger count generates only the top-up
  rows (a top-up row of a ragged wave keeps the index it has in the whole
  request, so it draws the noise it would draw in one drain).
  Classifier-guided requests are never cached.  With a persistent
  ``serve/store.py::SynthesisStore`` the cache spills to disk, so a cold
  process serves repeats with no sampler call.  The engine's cache and
  ``run``'s results hold torch tensors on the model's device; the store
  alone holds host copies.
* An exception mid-drain leaves every unserved request queued and CARRIES
  the rows the drain did produce to the next ``run``.  With
  ``run(on_error=...)`` a permanent failure of one group (a classifier
  closure that raises) resolves that group's requests to
  ``RequestFailedError`` through the hook and the drain serves the rest.
  A merged ragged engine probes a classifier closure at admission: the
  reference evaluates it abstractly (``jax.eval_shape``); the port has no
  abstract evaluation for a closure over CUDA parameters, so it calls the
  closure once on a (1, H, W, C) zero row on the model's device.
* ``stats`` is a read-only view over a ``MetricsRegistry``, the
  reference's keys in its order; ``tracer`` records spans and request
  lifecycle stamps at the reference's sites (off by default).

Placed multi-host drains (``topology=``, ``hosts=``, ``run(host_polls=)``,
``mesh=``) are refused with ``NotImplementedError``: they come with the
port's topology slice.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import plan_epochs
from repro_torch.diffusion.sampler import (sample_cfg, sample_cfg_compacted,
                                           sample_cfg_ragged,
                                           sample_classifier_guided,
                                           sample_mixed,
                                           sample_mixed_compacted,
                                           sample_uncond)
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.faults import (FaultInjector, RequestFailedError,
                                      RetryPolicy)

#: the reference's counter keys, in its order.  ``generated`` counts real
#: rows, ``scheduled_rows`` every row on the device (``generated +
#: padded``), ``row_iters_scheduled`` against ``row_iters_active`` the
#: denoiser rows run against those a real row needed
STAT_KEYS = ("requests", "waves", "generated", "scheduled_rows", "padded",
             "cache_hits", "store_hits", "streamed", "merged_waves",
             "compiled_shapes", "segments", "row_iters_scheduled",
             "row_iters_active")
GRANULE = 8               # wave rows round up to a multiple of this
COMPILE_COST = 256        # "auto" compaction's price of a new segment shape
PLACEMENT_LATER = ("placed multi-host drains are not ported yet; they come "
                   "with the topology slice (ROADMAP queue 1 item 4: "
                   "serve/topology.py, sharding/rules.py, launch/mesh.py)")


def refuse_placement(**knobs) -> None:
    for name, value in knobs.items():
        if value is not None:
            raise NotImplementedError(f"{name}={value!r}: {PLACEMENT_LATER}")


def _encoding_hash(encoding: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(encoding, np.float32)
                        .tobytes()).hexdigest()


@dataclass
class SynthesisRequest:
    rid: int
    mode: str                      # "cfg" | "clf" | "uncond"
    count: int
    category: int
    guidance: float
    num_steps: int
    cond: Optional[np.ndarray] = None      # (cond_dim,) or (count, cond_dim)
    logprob_fn: Optional[Callable] = None  # for mode "clf"
    group: Any = None                      # wave affinity for mode "clf"
    cache_key: Optional[tuple] = None


@dataclass
class _Pending:
    """A request admitted into a drain: ``fresh`` rows still to generate
    (count minus cache and planned coverage), packed into waves row by
    row."""
    req: SynthesisRequest
    fresh: int
    taken: int = 0                               # rows handed to waves
    chunks: list = field(default_factory=list)   # retired output slices

    def rows_left(self) -> int:
        return self.fresh - self.taken

    def row_block(self, k: int, start: int, null=None) -> np.ndarray:
        """Rows ``start:start+k`` of this request's fresh conditioning.  A
        1-D encoding repeats one row; a 2-D encoding slices, offset past
        the cached prefix, which covered the leading rows.  ``null`` (the
        DM's null row) is given on the merged ragged path, where
        classifier-guided and unconditional rows ride as null rows;
        without it the grouped packers get labels (classifier-guided) or
        placeholder ids (unconditional)."""
        r = self.req
        if r.mode == "cfg":
            if r.cond.ndim == 2:
                off = r.count - self.fresh + start
                return r.cond[off:off + k]
            return np.repeat(r.cond[None], k, axis=0)
        if null is not None:
            return np.repeat(null[None], k, axis=0)
        if r.mode == "clf":
            return np.full((k,), r.category, np.int64)
        return np.zeros((k,), np.int64)

    def done_rows(self) -> int:
        return sum(len(c) for c in self.chunks)


class _GroupQueue:
    """Live FIFO of pending requests of one wave group: the packer takes
    from it, so admissions mid-drain extend open waves."""

    def __init__(self, head: SynthesisRequest):
        self.head = head                          # mode, guidance, steps, clf
        self.items: deque[_Pending] = deque()
        # every pending ever pushed: ``take`` pops exhausted items, so
        # failure handling enumerates the group's admitted population here
        self.admitted: list[_Pending] = []

    def push(self, p: _Pending):
        self.items.append(p)
        if not any(q is p for q in self.admitted):
            self.admitted.append(p)

    def rows_available(self) -> int:
        return sum(p.rows_left() for p in self.items)

    def take(self, k: int) -> list[tuple[_Pending, int, int]]:
        """Peel up to ``k`` rows off the queue front, FIFO: (pending,
        rows taken, start row) triples."""
        parts: list[tuple[_Pending, int, int]] = []
        while k > 0 and self.items:
            p = self.items[0]
            t = min(p.rows_left(), k)
            if t:
                parts.append((p, t, p.taken))
                p.taken += t
                k -= t
            if p.rows_left() == 0:
                self.items.popleft()
        return parts


class _DrainState:
    """Book-keeping for one drain: live group queues, rows already planned
    per cache key (top-up accounting), requests waiting on rows another
    request generates, and the wave counter keying ``fold_in``."""

    def __init__(self):
        self.groups: dict[tuple, _GroupQueue] = {}
        self.planned: dict[tuple, int] = {}
        self.waiters: list[SynthesisRequest] = []
        self.admitted: set[int] = set()
        self.wave_i = 0
        self.started = False          # True once initial admission is done
        self.on_result = None         # this drain's streaming delivery hook
        self.on_error = None          # typed-failure delivery hook
        self.failed = {}              # rid -> RequestFailedError this drain
        self.tracer = None            # set by the engine at drain start

    def deliver(self, results: dict, rid: int, rows):
        if self.tracer is not None:
            self.tracer.stamp(rid, "deliver")
        results[rid] = rows
        if self.on_result is not None:
            self.on_result(rid, rows)


class SynthesisEngine:
    """Wave-based batched synthesis over a frozen DiT, on the model's
    device."""

    def __init__(self, model: DiT, sched: NoiseSchedule, *, image_size: int,
                 channels: int = 3, wave_size: int = 128, store=None,
                 async_waves: bool = True, ragged: bool = False,
                 compaction: int | str | None = None, topology=None,
                 hosts: int | None = None, mesh=None,
                 tracer: Tracer | None = None,
                 faults: FaultInjector | None = None,
                 retry: RetryPolicy | None = None):
        """``compaction`` is ``"full"``, ``"auto"`` or an int K >= 1 (see
        ``plan_epochs``), and implies ``ragged``; ``store`` a
        ``SynthesisStore`` the row cache spills to; ``async_waves=False``
        retires each wave before the next is launched."""
        refuse_placement(topology=topology, hosts=hosts, mesh=mesh)
        self.model, self.sched = model, sched
        self.dc = model.dc
        self.device = model.null_y.device
        self.image_size, self.channels = image_size, channels
        self.wave_size = max(-(-wave_size // GRANULE) * GRANULE, GRANULE)
        self.store = store
        self.async_waves = async_waves
        self.ragged = ragged
        self.compaction = None
        self.set_compaction(compaction)
        self._cache: dict[tuple, torch.Tensor] = {}
        self._queue: list[SynthesisRequest] = []
        self._next_rid = 0
        self.traj_shapes: set = set()    # distinct wave geometries
        # segment geometries (carried, rows, iterations) planned so far:
        # "auto" compaction treats a split into one of them as free; mixed
        # waves keep their own, as the reference's engine does
        self._segment_geoms: set[tuple] = set()
        self._segment_geoms_mixed: set[tuple] = set()
        # classifiers of merged ragged waves, by identity, in order of
        # first admission; a classifier-guided row selects its own by slot
        self._clf_fns: list = []
        self._null_row = model.null_y.detach().cpu().numpy()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.metrics = MetricsRegistry()
        self.faults = faults
        self.retry = retry if retry is not None else RetryPolicy()
        # rows produced by a drain that raised before returning: the next
        # ``run`` hands them to its caller
        self._carried: dict[int, torch.Tensor] = {}

    @property
    def stats(self) -> dict:
        """A fresh dict of the counters, read from the metrics registry;
        bump them through ``self.metrics``, not this view."""
        return {k: self.metrics.get(k) for k in STAT_KEYS}

    def set_compaction(self, compaction):
        """``None`` leaves the mode alone; ``"off"`` disables;
        ``"full"``/``"auto"``/int K enable (and imply ragged waves)."""
        if compaction is None:
            return
        if compaction == "off":
            self.compaction = None
            return
        if compaction not in ("full", "auto") and (
                not isinstance(compaction, int) or isinstance(compaction, bool)
                or compaction < 1):
            raise ValueError(
                f"compaction={compaction!r}: expected 'off', 'full', "
                f"'auto', or an int K >= 1")
        self.compaction = compaction
        self.ragged = True

    def opt_in(self, *, ragged: bool | None = None, compaction=None,
               tracer: Tracer | None = None,
               faults: FaultInjector | None = None,
               retry: RetryPolicy | None = None) -> "SynthesisEngine":
        """Switch scheduling knobs on, never off: ``ragged=True``,
        ``compaction`` (``"full"``/``"auto"``/int K), a ``tracer``, a
        fault injector and a retry policy; ``ragged=False``/``None``,
        ``compaction="off"``/``None`` and ``None`` elsewhere leave the
        engine as it is.  Every runner and the service share this
        contract.  Returns the engine."""
        if ragged:
            self.ragged = True
        if compaction != "off":
            self.set_compaction(compaction)
        if tracer is not None:
            self.tracer = tracer
        if faults is not None:
            self.faults = faults
        if retry is not None:
            self.retry = retry
        return self

    # -- submission -------------------------------------------------------
    def submit(self, encoding, category: int, count: int | None = None, *,
               guidance: float | None = None,
               num_steps: int | None = None) -> int:
        """Queue a classifier-free request (paper Eq. 8/9): ``count``
        samples of one conditioning row (a 1-D encoding), or one sample of
        each row of a 2-D ``(count, cond_dim)`` encoding (FedDISC's
        resampled statistics), one request and one cache entry.  Returns
        the request id; ids count up in submission order."""
        enc = np.ascontiguousarray(encoding, np.float32)
        if enc.ndim == 2:
            if count is not None and count != len(enc):
                raise ValueError(f"2-D encoding carries {len(enc)} rows; "
                                 f"count={count}")
            count = len(enc)
        elif enc.ndim != 1:
            raise ValueError(f"encoding must be a (cond_dim,) row or "
                             f"(count, cond_dim) rows, got shape {enc.shape}")
        elif count is None:
            raise ValueError("count is required for a 1-D encoding")
        g, steps = self._resolve(guidance, num_steps)
        return self._push(SynthesisRequest(
            rid=-1, mode="cfg", count=int(count), category=int(category),
            guidance=g, num_steps=steps, cond=enc,
            cache_key=(_encoding_hash(enc), g, steps)))

    def submit_classifier_guided(self, logprob_fn, category: int, count: int,
                                 *, guidance: float | None = None,
                                 num_steps: int | None = None,
                                 group: Any = None) -> int:
        """Queue ``count`` classifier-guided samples of ``category`` (Eq. 4 /
        FedCADO): ``logprob_fn(x, labels) -> (B,)`` log p(y|x), for instance
        ``models.classifiers.classifier_logprob(model)``.  ``group`` is the
        wave affinity of grouped waves: requests sharing it (one uploaded
        classifier) batch together, and the first one's classifier guides
        the wave; by default every request is its own group.  Never cached:
        a closure has no stable identity to key on."""
        g, steps = self._resolve(guidance, num_steps)
        return self._push(SynthesisRequest(
            rid=-1, mode="clf", count=int(count), category=int(category),
            guidance=g, num_steps=steps, logprob_fn=logprob_fn,
            group=group if group is not None else ("anon", self._next_rid)))

    def submit_unconditional(self, count: int, *, category: int = -1,
                             num_steps: int | None = None) -> int:
        """Queue ``count`` unguided draws from the DM's p(x), through the
        null embedding, cached under (``"uncond:<category>"``, 0.0,
        steps): ``category`` labels the rows and keys the request."""
        _, steps = self._resolve(0.0, num_steps)
        return self._push(SynthesisRequest(
            rid=-1, mode="uncond", count=int(count), category=int(category),
            guidance=0.0, num_steps=steps,
            cache_key=(f"uncond:{int(category)}", 0.0, steps)))

    # -- draining ---------------------------------------------------------
    def run(self, key, *, poll: Callable[[], bool] | None = None,
            host_polls=None, stream: bool | None = None,
            on_result: Callable[[int, torch.Tensor], None] | None = None,
            on_error: Callable[[int, Exception], None] | None = None,
            ) -> dict[int, torch.Tensor]:
        """Drain the queue with the threefry ``key``.  Returns rid →
        (count, H, W, C) images on the model's device.

        ``poll`` (a streaming drain) is called at every wave boundary and
        before the drain concludes; it may submit, and compatible requests
        join the open wave.  It returns truthy to keep the drain alive
        when the queues run dry.  ``stream`` defaults to ``poll is not
        None``.  ``on_result(rid, rows)`` is called the moment a request's
        rows exist, so a caller keeps what was served before a failure;
        ``on_error(rid, err)`` turns a permanent failure of one group into
        per-request ``RequestFailedError``s and the drain goes on.  A
        drain that raises carries its rows to the next ``run``."""
        refuse_placement(host_polls=host_polls or None)
        key = np.asarray(key, np.uint32)
        stream = (poll is not None) if stream is None else stream
        results: dict[int, torch.Tensor] = {}
        failed: dict[int, Exception] = {}
        if self.store is not None:
            # store I/O lands on the engine's metrics and timeline and
            # recovers under its fault policy
            self.store.bind(self.metrics, self.tracer, faults=self.faults,
                            retry=self.retry)
        if self._carried:
            # rows a previous drain produced but never returned (it raised
            # first): their requests already left the queue
            carried, self._carried = self._carried, {}
            results.update(carried)
            if on_result is not None:
                for rid, rows in carried.items():
                    on_result(rid, rows)
        with self.tracer.span("drain", queued=len(self._queue)):
            try:
                self._drain(key, results, failed, poll=poll, stream=stream,
                            on_result=on_result, on_error=on_error)
            except BaseException:
                self._carried.update(results)
                raise
            finally:
                if self.store is not None:
                    self.store.flush()
                # in place, not a rebuild: another thread's submit may
                # append meanwhile
                for r in [r for r in self._queue
                          if r.rid in results or r.rid in failed]:
                    self._queue.remove(r)
        return results

    # -- internals --------------------------------------------------------
    def _resolve(self, guidance, num_steps):
        g = self.dc.guidance_scale if guidance is None else float(guidance)
        return g, int(num_steps or self.dc.sample_timesteps)

    def _push(self, req: SynthesisRequest) -> int:
        req.rid = self._next_rid
        self._next_rid += 1
        self._queue.append(req)
        self.metrics.inc("requests")
        self.tracer.stamp(req.rid, "admit")
        return req.rid

    def _group_key(self, r: SynthesisRequest):
        if self.ragged:
            return ("cfg",)           # one merged group for every mode
        clf = ("clf", repr(r.group)) if r.mode == "clf" else ("", "")
        return (r.mode, r.guidance, r.num_steps) + clf

    def _clf_slot(self, fn) -> int:
        """Slot of ``fn`` in the classifier registry (identity match),
        appended at first sight, which is at admission."""
        for i, f in enumerate(self._clf_fns):
            if f is fn:
                return i
        self._clf_fns.append(fn)
        return len(self._clf_fns) - 1

    def _cached_rows(self, ck) -> Optional[torch.Tensor]:
        """The row cache, spilling in from the store on a miss (one copy to
        the model's device)."""
        rows = self._cache.get(ck)
        if rows is None and self.store is not None:
            host = self.store.get(ck)
            if host is not None:
                rows = torch.as_tensor(host).to(self.device)
                self._cache[ck] = rows
                self.metrics.inc("store_hits", len(rows))
        return rows

    def _plan_waves(self, n: int) -> tuple[int, int]:
        """(waves, rows a wave) of a snapshot group of n rows: near-uniform
        waves, padding under one granule a wave."""
        nw = -(-n // self.wave_size)
        per_wave = -(-n // nw)
        return nw, -(-per_wave // GRANULE) * GRANULE

    def _note_shape(self, sig: tuple):
        """Count distinct wave geometries, as the reference counts its
        compiled ones."""
        self.traj_shapes.add(sig)
        self.metrics.set_gauge("compiled_shapes", len(self.traj_shapes))

    def _row_keys(self, meta, key):
        """``fold_in(fold_in(drain_key, rid), row_index)`` for every row: a
        function of the row's identity, not of its wave."""
        rids = np.array([m[2] for m in meta], np.int64)
        ridx = np.array([m[3] for m in meta], np.int64)
        return prng.fold_in(prng.fold_in(key[None], rids), ridx)

    def _mixed_columns(self, meta):
        """(mode, classifier slot, label) vectors of a mixed wave, and the
        registry's classifiers."""
        return (np.array([m[4] for m in meta], np.float32),
                np.array([m[5] for m in meta], np.int64),
                np.array([m[6] for m in meta], np.int64))

    def _sample_wave_ragged(self, cond_rows, meta, key, max_steps: int):
        """One merged wave, one-shot or compacted, mixed when it holds a
        classifier-guided row.  Returns (images, scheduled row-iterations,
        padding included)."""
        g = np.array([m[0] for m in meta], np.float32)
        steps = np.array([m[1] for m in meta], np.int32)
        row_keys = self._row_keys(meta, key)
        mixed = any(m[4] for m in meta)
        kw = dict(max_steps=max_steps, image_size=self.image_size,
                  channels=self.channels)
        ops = ()
        if mixed:
            ops = self._mixed_columns(meta)
            kw["clf_fns"] = tuple(self._clf_fns)
        nclf = len(self._clf_fns)
        if self.compaction is None:
            self._note_shape(("mixed-ragged", len(cond_rows), max_steps, nclf)
                             if mixed else
                             ("cfg-ragged", len(cond_rows), max_steps))
            sampler = sample_mixed if mixed else sample_cfg_ragged
            x = sampler(self.model, self.sched, cond_rows, row_keys, g, *ops,
                        steps, **kw)
            return x, len(meta) * max_steps
        geoms = self._segment_geoms_mixed if mixed else self._segment_geoms
        plan = plan_epochs(steps, max_steps, compaction=self.compaction,
                           geoms=geoms,
                           compile_cost=COMPILE_COST)
        prev = 0
        for rows, begin, end in plan[1]:
            self._note_shape(("mixed-seg", prev, rows, end - begin, nclf)
                             if mixed else
                             ("cfg-seg", prev, rows, end - begin))
            geoms.add((prev, rows, end - begin))
            prev = rows
        self.metrics.inc("segments", len(plan[1]))
        sampler = sample_mixed_compacted if mixed else sample_cfg_compacted
        x = sampler(self.model, self.sched, cond_rows, row_keys, g, *ops,
                    steps, plan=plan, **kw)
        return x, sum(rows * (end - begin) for rows, begin, end in plan[1])

    def _sample_wave(self, head: SynthesisRequest, cond_rows, key):
        """One grouped wave of ``head``'s mode from the wave key."""
        kw = dict(image_size=self.image_size, channels=self.channels,
                  num_steps=head.num_steps)
        n = len(cond_rows)
        if head.mode == "cfg":
            self._note_shape(("cfg", n, head.num_steps, head.guidance))
            return sample_cfg(self.model, self.sched, cond_rows, key,
                              guidance=head.guidance, **kw)
        if head.mode == "clf":
            self._note_shape(("clf", repr(head.group), n, head.num_steps,
                              head.guidance))
            return sample_classifier_guided(
                self.model, self.sched, head.logprob_fn, cond_rows, key,
                guidance=head.guidance, **kw)
        self._note_shape(("uncond", n, head.num_steps))
        return sample_uncond(self.model, self.sched, n, key, **kw)

    # -- drain machinery --------------------------------------------------
    def _drain(self, key, results, failed, *, poll, stream, on_result=None,
               on_error=None):
        st = _DrainState()
        st.on_result, st.on_error, st.failed = on_result, on_error, failed
        st.tracer = self.tracer
        with self.tracer.span("drain.admit"):
            self._admit_new(st, results)
        st.started = True             # later admissions count as streamed
        while True:
            live = sorted(g for g, q in st.groups.items()
                          if q.rows_available())
            if not live:
                if poll is not None and poll():
                    self._admit_new(st, results)
                    continue
                break
            grp = st.groups[live[0]]
            try:
                self._drain_group(grp, st, key, results, poll=poll,
                                  stream=stream)
            except Exception as exc:
                # with an on_error hook a permanent failure inside one
                # group fails that group's requests and the drain goes on;
                # without one it raises and the queues stay as they are
                if st.on_error is None:
                    raise
                self._fail_group(grp, st, results, exc)
        # waiters still unresolved are covered by rows generated above
        self._serve_waiters(st, results)

    def _check_fault(self, site: str, *, host: int = 0, wave: int = -1):
        """Injectable fault site: counts what fires, then lets it raise."""
        if self.faults is None:
            return
        try:
            self.faults.check(site, host=host, wave=wave)
        except Exception:
            self.metrics.inc("fault.injected", site=site)
            raise

    def _fence(self, done, *, host: int, wave: int):
        """Wait for one wave's work (``done``: a CUDA event recorded after
        it, or None on the CPU) under the ``scan`` fault site and the
        engine's retry policy."""
        def attempt():
            self._check_fault("scan", host=host, wave=wave)
            if done is not None:
                done.synchronize()
        self.retry.run(attempt, metrics=self.metrics, site="device.scan")

    def _fail_group(self, grp: _GroupQueue, st: _DrainState, results, exc):
        """Resolve every unserved request admitted to ``grp`` to a
        ``RequestFailedError`` through ``on_error``, release its planned
        rows, fail waiters on a key left uncovered, clear the queue."""
        doomed = []
        for p in grp.admitted:
            rid = p.req.rid
            if rid in results or rid in st.failed or \
                    any(d.req.rid == rid for d in doomed):
                continue
            doomed.append(p)
        bad_keys = set()
        for p in doomed:
            r = p.req
            if r.cache_key is not None:
                left = st.planned.get(r.cache_key, 0) - p.fresh
                st.planned[r.cache_key] = max(left, 0)
                bad_keys.add(r.cache_key)
            self._fail_request(st, r, exc)
        still = []
        for r in st.waiters:
            cached = self._cache.get(r.cache_key)
            covered = cached is not None and len(cached) >= r.count
            if r.cache_key in bad_keys and not covered:
                self._fail_request(st, r, exc)
            else:
                still.append(r)
        st.waiters = still
        grp.items.clear()

    def _fail_request(self, st: _DrainState, r: SynthesisRequest, exc):
        err = RequestFailedError(
            f"request {r.rid} ({r.mode}) failed permanently: {exc}",
            rid=r.rid)
        err.__cause__ = exc
        st.failed[r.rid] = err
        self.metrics.inc("requests_failed")
        self.tracer.instant("request.failed", rid=r.rid)
        if st.on_error is not None:
            st.on_error(r.rid, err)

    def _probe_classifier(self, fn) -> None:
        """Call a classifier closure once on a (1, H, W, C) zero row on the
        model's device: a closure that raises is caught at admission,
        before a mixed wave would carry it."""
        H, C = self.image_size, self.channels
        with torch.no_grad():
            fn(torch.zeros((1, H, H, C), device=self.device),
               torch.zeros((1,), dtype=torch.int64, device=self.device))

    def _admit_new(self, st: _DrainState, results):
        """Admission: serve full cache hits, count each request's top-up
        ``fresh`` rows against the cache and the rows already planned this
        drain, and push the rest onto their live group queues."""
        for r in list(self._queue):
            if r.rid in st.admitted:
                continue
            st.admitted.add(r.rid)
            if st.started:
                self.metrics.inc("streamed")
            if r.count <= 0:
                st.deliver(results, r.rid, torch.zeros(
                    (0, self.image_size, self.image_size, self.channels),
                    device=self.device))
                continue
            have = 0
            if r.cache_key is not None:
                cached = self._cached_rows(r.cache_key)
                have = ((0 if cached is None else len(cached))
                        + st.planned.get(r.cache_key, 0))
            fresh = max(r.count - have, 0)
            self.metrics.inc("cache_hits", r.count - fresh)
            if fresh == 0:
                cached = self._cached_rows(r.cache_key)
                if cached is not None and len(cached) >= r.count:
                    st.deliver(results, r.rid, cached[:r.count].clone())
                else:
                    # covered by rows another request planned this drain:
                    # served once the wave that makes them retires
                    st.waiters.append(r)
                continue
            if r.mode == "clf" and self.ragged:
                # a merged wave would carry a bad closure into every row
                # beside it, so it is probed here; with on_error the request
                # fails alone, without it the drain raises
                try:
                    self._probe_classifier(r.logprob_fn)
                    self._clf_slot(r.logprob_fn)
                except Exception as exc:
                    if st.on_error is None:
                        raise
                    self._fail_request(st, r, exc)
                    continue
            if r.cache_key is not None:
                st.planned[r.cache_key] = (st.planned.get(r.cache_key, 0)
                                           + fresh)
            gk = self._group_key(r)
            if gk not in st.groups:
                st.groups[gk] = _GroupQueue(r)
            self.tracer.stamp(r.rid, "enqueue")
            st.groups[gk].push(_Pending(r, fresh))

    def _drain_group(self, q: _GroupQueue, st: _DrainState, key, results, *,
                     poll, stream):
        """Drain one group's live queue wave by wave, double-buffered: wave
        k+1 is packed and launched while wave k runs on the card."""
        ragged = self.ragged
        if stream:
            wave_rows = self.wave_size
        else:
            _, wave_rows = self._plan_waves(q.rows_available())
        smax = 0                 # the ragged step ceiling, a running max
        inflight = None          # (x, done event, parts, real rows, wave)
        while True:
            # admission at every wave boundary, poll or not: requests
            # another thread submits stream into this drain too
            if poll is not None:
                poll()
            self._admit_new(st, results)
            parts = q.take(wave_rows)
            got = sum(t for _, t, _ in parts)
            if got == 0:
                break
            if got < wave_rows:
                # an open wave: late arrivals get one chance to fill it
                if poll is not None:
                    poll()
                self._admit_new(st, results)
                more = q.take(wave_rows - got)
                parts += more
                got += sum(t for _, t, _ in more)
            # the tail: a snapshot keeps the group's wave size, a stream
            # rounds up to a granule
            target = -(-got // GRANULE) * GRANULE if stream else wave_rows
            with self.tracer.span("wave.pack", wave=st.wave_i, host=0,
                                  rows=target, real=got):
                rows = np.concatenate(
                    [p.row_block(t, s, self._null_row if ragged else None)
                     for p, t, s in parts])
                meta = None
                if ragged:
                    # (guidance, steps, rid, row index, mode, classifier
                    # slot, label); the index counts past the cached
                    # prefix, so a top-up row keeps its identity
                    meta = [(p.req.guidance, p.req.num_steps, p.req.rid,
                             p.req.count - p.fresh + s + i,
                             1.0 if p.req.mode == "clf" else 0.0,
                             (self._clf_slot(p.req.logprob_fn)
                              if p.req.mode == "clf" else 0),
                             p.req.category)
                            for p, t, s in parts for i in range(t)]
                if target > got:
                    # padding repeats the last row, identity and all, and
                    # is discarded
                    rows = np.concatenate(
                        [rows, np.repeat(rows[-1:], target - got, axis=0)])
                    if ragged:
                        meta += [meta[-1]] * (target - got)
            for p, _, _ in parts:
                self.tracer.stamp(p.req.rid, "pack")
            wave = st.wave_i
            st.wave_i += 1
            with self.tracer.span("wave.dispatch", wave=wave, host=0,
                                  rows=target, mode=q.head.mode) as sp:
                if ragged:
                    smax = max(smax, *(m[1] for m in meta))
                    x, sched_iters = self._sample_wave_ragged(rows, meta,
                                                              key, smax)
                    self.metrics.inc("merged_waves")
                    self.metrics.inc("row_iters_scheduled", sched_iters)
                    self.metrics.inc("row_iters_active",
                                     int(sum(m[1] for m in meta[:got])))
                    sp.set(iters_scheduled=sched_iters)
                else:
                    x = self._sample_wave(q.head, rows,
                                          prng.fold_in(key, wave))
                    self.metrics.inc("row_iters_scheduled",
                                     target * q.head.num_steps)
                    self.metrics.inc("row_iters_active",
                                     got * q.head.num_steps)
            done = None
            if x.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(x.device))
            for p, _, _ in parts:
                self.tracer.stamp(p.req.rid, "dispatch")
            self.metrics.inc("waves")
            self.metrics.inc("generated", got)
            self.metrics.inc("scheduled_rows", target)
            self.metrics.inc("padded", target - got)
            if inflight is not None:
                self._retire(st, results, *inflight)
                inflight = None
            if self.async_waves:
                inflight = (x, done, parts, got, wave)
            else:
                self._retire(st, results, x, done, parts, got, wave)
        if inflight is not None:
            self._retire(st, results, *inflight)

    def _retire(self, st: _DrainState, results, x, done, parts, n_real,
                wave: int = -1):
        """Wait for the wave's own work, scatter its rows to their
        requests, finalize each request whose rows are complete."""
        with self.tracer.span("device.scan", host=0, rows=int(x.shape[0])):
            self._fence(done, host=0, wave=wave)
        outs = x[:n_real]
        off = 0
        for p, t, _ in parts:
            p.chunks.append(outs[off:off + t])
            off += t
            if p.done_rows() == p.fresh:
                self._finalize(st, p, results)

    def _finalize(self, st: _DrainState, p: _Pending, results):
        self.tracer.stamp(p.req.rid, "retire")
        new = (torch.cat(p.chunks) if p.chunks else torch.zeros(
            (0, self.image_size, self.image_size, self.channels),
            device=self.device))
        r = p.req
        if r.cache_key is None:
            st.deliver(results, r.rid, new)
            return
        have = self._cache.get(r.cache_key)
        merged = new if have is None else torch.cat([have, new])
        self._cache[r.cache_key] = merged
        # these rows moved from planned to cached
        left = st.planned.get(r.cache_key, 0) - p.fresh
        st.planned[r.cache_key] = max(left, 0)
        if self.store is not None:
            self.store.put(r.cache_key, merged)
        st.deliver(results, r.rid, merged[:r.count].clone())
        self._serve_waiters(st, results)

    def _serve_waiters(self, st: _DrainState, results):
        still = []
        for r in st.waiters:
            cached = self._cache.get(r.cache_key)
            if cached is not None and len(cached) >= r.count:
                st.deliver(results, r.rid, cached[:r.count].clone())
            else:
                still.append(r)
        st.waiters = still
