"""Batched D_syn synthesis: wave-scheduled diffusion sampling, the JAX
package's ``serve/synthesis.py`` for the port.

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
  reference's keys in its order; ``tracer`` (the process default,
  ``obs/trace.py::default``, when not given; off until enabled) records
  spans and request lifecycle stamps at the reference's sites, and is
  current on the drain thread while ``run`` drains, so the DiT's
  ``flash_attention`` calls are spans of it.  ``wave.dispatch`` times the
  launches of a wave, which wait whenever the launch queue is full: on a
  card-bound drain it times the wave.  ``device.scan`` is the host's wait
  on a wave's event.  Port-only: ``wave.admit``, the poll, admission and
  take at each wave boundary (a sibling before ``wave.pack``; the two are
  the boundary's host work, with no launch-queue wait or fence in them),
  and, on a card, ``wave.device``, one instant a retired wave of a
  grouped drain: ``device_ms`` from the wave's first launch to its end and
  ``gap_ms`` from the previous wave's end to its start, from CUDA timing
  events read after the wave's fence.
* PLACED DRAINS (``topology=HostTopology(...)`` or ``hosts=H``,
  ``serve/topology.py``): a classifier-free request (every request, when
  the engine is ragged) is routed to a host's INGRESS QUEUE by its
  identity (``rid`` over the live hosts); each host packs its own
  contiguous WINDOW of every wave (padding per window), and the wave's
  per-row scalars live in ONE wave-resident table, built once per wave by
  ``ragged_tables`` over the whole wave and uploaded once, that every
  window's segment chain reads at ``row_offset = window.offset``
  (``cfg_update_rowwise`` / ``cfg_update_mixed``).  Placed waves are
  always row-keyed, so a row's value does not depend on the host count or
  the placement.  Compaction plans each window alone.  Hosts are
  simulated in one process; a topology made from a mesh
  (``launch/mesh.py``) places each window on its host's data devices
  (``sharding/rules.py::wave_window_specs``).  Per-host counters land in
  ``stats["per_host"]``.
* HOST STREAMS (``workers=True``, the default): each host's windows
  launch on a CUDA stream of the host's own, one per (host, device).  The
  drain thread packs every window of a wave, checks every host's
  ``window`` fault site before any window launches, uploads the wave
  table, launches each window on its host's stream (which waits on the
  table's upload event) and then fences each window on the event recorded
  after its own work.  There are no worker threads: launching from one
  thread per host ran 2-4x slower on an H100, since every PyTorch op
  releases and retakes the GIL (``tools/worker_dispatch_probe.py``), and
  on one card the streams gave no wall gain over ``workers=False`` either
  (PERF.md): the host's launch rate bounds the drain, so windows of
  different hosts overlap only around the fences.  ``workers=False``
  launches every window on the drain thread's current stream: the same
  kernels at the same shapes, the same bits.
* FAILOVER: a ``window`` fault (``HostLostError``) marks the host failed
  before any window of its wave launched; every host lost in that wave is
  found first (``err.also``).  The wave in flight is retired, the aborted
  wave's rows go back on their queues and the dead hosts' requests move
  to survivors.  The wave's index is burnt only when it dispatches.
  Losing every host raises ``AllHostsLostError`` with the queues intact.
* PER-HOST ADMISSION (``run(host_polls={h: hook})``): every live host's
  hook runs at every wave boundary beside ``poll``; a dead host's hook is
  dropped.
* ``mesh=`` (a ``launch/mesh.py::Mesh``) rounds the granule to the mesh's
  data size; an unplaced row-keyed wave splits its rows over the data
  devices as the windows do, a grouped wave (noise drawn for the whole
  wave from one key) runs whole on the first.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import plan_epochs, ragged_tables
from repro_torch.diffusion.sampler import (_window_segment,
                                           _window_segment_mixed, sample_cfg,
                                           sample_cfg_compacted,
                                           sample_cfg_ragged,
                                           sample_classifier_guided,
                                           sample_mixed,
                                           sample_mixed_compacted,
                                           sample_uncond)
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.launch.mesh import (Mesh, NamedSharding, data_devices,
                                     mesh_axes)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, default as default_tracer, using
from repro_torch.serve.faults import (AllHostsLostError, FaultInjector,
                                      HostLostError, RequestFailedError,
                                      RetryPolicy)
from repro_torch.serve.topology import HostTopology, HostWindow, WavePlacement
from repro_torch.sharding.rules import wave_window_specs

#: the reference's counter keys, in its order.  ``generated`` counts real
#: rows, ``scheduled_rows`` every row on the device (``generated +
#: padded``), ``row_iters_scheduled`` against ``row_iters_active`` the
#: denoiser rows run against those a real row needed
STAT_KEYS = ("requests", "waves", "generated", "scheduled_rows", "padded",
             "cache_hits", "store_hits", "streamed", "merged_waves",
             "compiled_shapes", "segments", "row_iters_scheduled",
             "row_iters_active")
#: per-host counters under a topology (``stats["per_host"]``)
HOST_STAT_KEYS = ("rows", "padded", "waves", "row_iters_scheduled",
                  "row_iters_active", "queue_depth_at_start")
GRANULE = 8               # wave rows round up to a multiple of this
COMPILE_COST = 256        # "auto" compaction's price of a new segment shape


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


class _ShardedGroup:
    """Per-host ingress of one wave group under a topology: one live
    ``_GroupQueue`` per host, so each host packs its window of a placed
    wave from its own queue, and streams its own late arrivals."""

    def __init__(self, head: SynthesisRequest, num_hosts: int):
        self.head = head
        self.queues = [_GroupQueue(head) for _ in range(num_hosts)]

    def push(self, p: _Pending, host: int):
        self.queues[host].push(p)

    def rows_available(self) -> int:
        return sum(q.rows_available() for q in self.queues)


@dataclass
class _WindowOut:
    """One dispatched window: per device chunk, its rows (window order, in
    the window's activation order under compaction) and the CUDA event
    recorded after its work (None on the CPU)."""
    chunks: list

    def synchronize(self):
        for _, done in self.chunks:
            if done is not None:
                done.synchronize()


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
        self.last_done = None         # the last retired wave's timed event

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
                 compaction: int | str | None = None,
                 topology: HostTopology | None = None,
                 hosts: int | None = None, mesh=None, workers: bool = True,
                 tracer: Tracer | None = None,
                 faults: FaultInjector | None = None,
                 retry: RetryPolicy | None = None):
        """``compaction`` is ``"full"``, ``"auto"`` or an int K >= 1 (see
        ``plan_epochs``), and implies ``ragged``; ``store`` a
        ``SynthesisStore`` the row cache spills to; ``async_waves=False``
        retires each wave before the next is launched.  ``topology`` (a
        ``HostTopology``) or ``hosts`` (an int H) places drains over hosts,
        each host's windows on a CUDA stream of its own unless ``workers``
        is False; ``mesh`` (a ``launch/mesh.py::Mesh``) rounds the row
        granule up to a multiple of its data size and places rows on its
        data devices."""
        self.model, self.sched = model, sched
        self.dc = model.dc
        self.device = model.null_y.device
        self.image_size, self.channels = image_size, channels
        self.mesh = mesh
        self._data_devices = None
        granule = GRANULE
        if mesh is not None:
            devs = data_devices(mesh)
            granule = -(-granule // len(devs)) * len(devs)
            if devs != (self.device,):
                self._data_devices = devs
        self.granule = granule
        self.wave_size = max(-(-wave_size // granule) * granule, granule)
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
        self.tracer = tracer if tracer is not None else default_tracer()
        self.metrics = MetricsRegistry()
        self.faults = faults
        self.retry = retry if retry is not None else RetryPolicy()
        # rows produced by a drain that raised before returning: the next
        # ``run`` hands them to its caller
        self._carried: dict[int, torch.Tensor] = {}
        self.topology = None
        # "auto" compaction's segment geometries per (window offset, wave
        # rows[, "mixed"]), as the reference keys its window executables
        self._window_geoms: dict[tuple, set] = {}
        self._host_shardings: dict[int, dict] = {}
        self._replicas: dict[torch.device, DiT] = {}
        self.workers = workers
        self._streams: dict[tuple, torch.cuda.Stream] = {}
        # test seam: called as (site, host, wave) just after a window's
        # launch ("dispatch") and before its fence ("fence")
        self._sync_hook = None
        if topology is not None or hosts is not None:
            self.set_topology(topology if topology is not None else hosts)

    @property
    def stats(self) -> dict:
        """A fresh dict of the counters, read from the metrics registry;
        bump them through ``self.metrics``, not this view.  Under a
        topology it also holds ``hosts`` and ``per_host``, one dict of
        ``HOST_STAT_KEYS`` a host."""
        m = self.metrics
        s = {k: m.get(k) for k in STAT_KEYS}
        if self.topology is not None:
            s["hosts"] = self.topology.num_hosts
            s["per_host"] = [{k: m.get(f"host.{k}", host=h)
                              for k in HOST_STAT_KEYS}
                             for h in range(self.topology.num_hosts)]
        return s

    def set_topology(self, topology):
        """Apply the placement knob.  ``None`` leaves the topology alone;
        an int H builds one: H host partitions of the engine's mesh when it
        has one, else H simulated hosts whose windows round to the engine's
        granule.  Re-applying an equal topology (the same fleet, or it with
        hosts the engine has since marked failed) is a no-op, so a shared
        engine's ``opt_in`` neither wipes the per-host counters nor brings
        a dead host back; another topology resets them."""
        if topology is None:
            return
        if isinstance(topology, bool) or not isinstance(
                topology, (int, HostTopology)):
            raise ValueError(f"topology={topology!r}: expected a "
                             f"HostTopology or an int host count")
        if isinstance(topology, int):
            topology = (HostTopology.from_mesh(self.mesh, topology)
                        if self.mesh is not None else
                        HostTopology.simulated(topology,
                                               granule=self.granule))
        if topology == self.topology or (
                self.topology is not None
                and topology == replace(self.topology, failed=frozenset())):
            return
        self.topology = topology
        self._host_shardings = {}
        self.metrics.drop("host.")
        self.metrics.set_gauge("hosts", topology.num_hosts)
        for h in range(topology.num_hosts):
            for k in HOST_STAT_KEYS:
                self.metrics.counter(f"host.{k}", host=h)

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
               topology=None, hosts: int | None = None,
               tracer: Tracer | None = None,
               faults: FaultInjector | None = None,
               retry: RetryPolicy | None = None) -> "SynthesisEngine":
        """Switch scheduling knobs on, never off: ``ragged=True``,
        ``compaction`` (``"full"``/``"auto"``/int K), a ``topology`` or
        ``hosts``, a ``tracer``, a fault injector and a retry policy;
        ``ragged=False``/``None``, ``compaction="off"``/``None`` and
        ``None`` elsewhere leave the engine as it is.  Every runner and the
        service share this contract.  Returns the engine."""
        if ragged:
            self.ragged = True
        if compaction != "off":
            self.set_compaction(compaction)
        self.set_topology(topology if topology is not None else hosts)
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
        when the queues run dry.  ``host_polls`` (under a topology) maps
        host ids to per-host hooks of the same contract: every live host's
        hook runs at every wave boundary beside ``poll``, a dead host's is
        dropped.  ``stream`` defaults to ``poll is not None or
        bool(host_polls)``.  ``on_result(rid, rows)`` is called the moment
        a request's rows exist, so a caller keeps what was served before a
        failure; ``on_error(rid, err)`` turns a permanent failure of one
        group into per-request ``RequestFailedError``s and the drain goes
        on (``AllHostsLostError`` still raises).  A drain that raises
        carries its rows to the next ``run``."""
        key = np.asarray(key, np.uint32)
        stream = ((poll is not None or bool(host_polls))
                  if stream is None else stream)
        if host_polls:
            if self.topology is None:
                raise ValueError("host_polls requires a topology "
                                 "(hosts=H / topology=HostTopology(...))")
            bad = [h for h in host_polls
                   if not 0 <= h < self.topology.num_hosts]
            if bad:
                raise ValueError(f"host_polls hosts {bad} out of range for "
                                 f"{self.topology.num_hosts} hosts")
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
        with using(self.tracer), \
                self.tracer.span("drain", queued=len(self._queue)):
            try:
                self._drain(key, results, failed, poll=poll,
                            host_polls=host_polls, stream=stream,
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
        return nw, -(-per_wave // self.granule) * self.granule

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
            if self._data_devices is not None:
                x = self._sample_split(cond_rows, meta, key, max_steps, mixed,
                                       (None, ((len(meta), 0, max_steps),)))
                return x, len(meta) * max_steps
            sampler = sample_mixed if mixed else sample_cfg_ragged
            x = sampler(self.model, self.sched, cond_rows, row_keys, g, *ops,
                        steps, **kw)
            return x, len(meta) * max_steps
        geoms = self._segment_geoms_mixed if mixed else self._segment_geoms
        plan = plan_epochs(steps, max_steps, compaction=self.compaction,
                           granule=self.granule if self.mesh is not None
                           else 1, geoms=geoms,
                           compile_cost=COMPILE_COST)
        prev = 0
        for rows, begin, end in plan[1]:
            self._note_shape(("mixed-seg", prev, rows, end - begin, nclf)
                             if mixed else
                             ("cfg-seg", prev, rows, end - begin))
            geoms.add((prev, rows, end - begin))
            prev = rows
        self.metrics.inc("segments", len(plan[1]))
        if self._data_devices is not None:
            x = self._sample_split(cond_rows, meta, key, max_steps, mixed,
                                   plan)
        else:
            sampler = (sample_mixed_compacted if mixed
                       else sample_cfg_compacted)
            x = sampler(self.model, self.sched, cond_rows, row_keys, g, *ops,
                        steps, plan=plan, **kw)
        return x, sum(rows * (end - begin) for rows, begin, end in plan[1])

    def _sample_split(self, cond_rows, meta, key, max_steps: int,
                      mixed: bool, plan):
        """An unplaced row-keyed wave on a mesh of several data devices:
        its rows, in the ``plan``'s activation order (``(order, epochs)``;
        order None for one segment), split evenly over the data devices as
        a placed window's are, then back in request order on the engine's
        device."""
        order, epochs = plan
        if order is not None:
            cond_rows, meta = cond_rows[order], [meta[i] for i in order]
        ctx = self._wave_ctx(cond_rows, meta, key, max_steps, mixed,
                             len(meta))
        x = self._window_rows(self._run_chunks(
            0, len(meta), self._layout(self.mesh), epochs, ctx, -1))
        if order is not None:
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            x = x[torch.as_tensor(inv, device=x.device)]
        return x

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
    def _drain(self, key, results, failed, *, poll, stream, host_polls=None,
               on_result=None, on_error=None):
        st = _DrainState()
        st.on_result, st.on_error, st.failed = on_result, on_error, failed
        st.tracer = self.tracer
        with self.tracer.span("drain.admit"):
            self._admit_new(st, results)
        st.started = True             # later admissions count as streamed
        if self.topology is not None:
            for h, q in enumerate(self._host_depths(st)):
                self.metrics.inc("host.queue_depth_at_start", q, host=h)
        polling = poll is not None or bool(host_polls)
        while True:
            live = sorted(g for g, q in st.groups.items()
                          if q.rows_available())
            if not live:
                if polling and self._poll_all(poll, host_polls):
                    self._admit_new(st, results)
                    continue
                break
            grp = st.groups[live[0]]
            try:
                drain = (self._drain_group_placed
                         if isinstance(grp, _ShardedGroup)
                         else self._drain_group)
                drain(grp, st, key, results, poll=poll,
                      host_polls=host_polls, stream=stream)
            except Exception as exc:
                # with an on_error hook a permanent failure inside one
                # group fails that group's requests and the drain goes on;
                # without one, or with no host left, it raises and the
                # queues stay as they are
                if st.on_error is None or isinstance(exc, AllHostsLostError):
                    raise
                self._fail_group(grp, st, results, exc)
        # waiters still unresolved are covered by rows generated above
        self._serve_waiters(st, results)

    def _host_depths(self, st: _DrainState) -> list[int]:
        """Rows waiting on each host's ingress queues now."""
        depths = [0] * self.topology.num_hosts
        for grp in st.groups.values():
            if isinstance(grp, _ShardedGroup):
                for h, q in enumerate(grp.queues):
                    depths[h] += q.rows_available()
        return depths

    def _poll_all(self, poll, host_polls) -> bool:
        """Run ``poll`` and every live host's hook (all of them: a hook's
        side effect is its host's submissions); truthy if any asks to keep
        the drain alive.  Hooks of hosts that have failed are dropped."""
        more = False
        if poll is not None:
            more = bool(poll()) or more
        if host_polls:
            live = (self.topology.live_hosts
                    if self.topology is not None else ())
            for h, hook in host_polls.items():
                if h in live:
                    more = bool(hook()) or more
        return more

    def _host_stream(self, host: int, device: torch.device):
        """Host ``host``'s stream on ``device`` under ``workers``, made at
        first use; None (the current stream) on the CPU or with
        ``workers=False``."""
        if not self.workers or device.type != "cuda":
            return None
        k = (host, device)
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(device)
        return self._streams[k]

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
        it, a placed window's ``_WindowOut``, or None on the CPU) under the
        ``scan`` fault site and the engine's retry policy."""
        def attempt():
            self._check_fault("scan", host=host, wave=wave)
            if done is not None:
                done.synchronize()
        self.retry.run(attempt, metrics=self.metrics, site="device.scan")

    def _fail_group(self, grp, st: _DrainState, results, exc):
        """Resolve every unserved request admitted to ``grp`` (a group
        queue, or a sharded group's host queues) to a
        ``RequestFailedError`` through ``on_error``, release its planned
        rows, fail waiters on a key left uncovered, clear the queues."""
        queues = grp.queues if isinstance(grp, _ShardedGroup) else [grp]
        doomed = []
        for p in (p for q in queues for p in q.admitted):
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
        for q in queues:
            q.items.clear()

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
            # under a topology classifier-free groups place, and every
            # group of a ragged engine (its one merged group)
            placed = self.topology is not None and (r.mode == "cfg"
                                                    or self.ragged)
            if gk not in st.groups:
                st.groups[gk] = (_ShardedGroup(r, self.topology.num_hosts)
                                 if placed else _GroupQueue(r))
            self.tracer.stamp(r.rid, "enqueue")
            if placed:
                # routed by identity, not arrival order: a replayed trace
                # lands every request on the same host
                st.groups[gk].push(_Pending(r, fresh),
                                   self.topology.assign(r.rid))
            else:
                st.groups[gk].push(_Pending(r, fresh))

    def _drain_group(self, q: _GroupQueue, st: _DrainState, key, results, *,
                     poll, host_polls, stream):
        """Drain one group's live queue wave by wave, double-buffered: wave
        k+1 is packed and launched while wave k runs on the card."""
        ragged = self.ragged
        if stream:
            wave_rows = self.wave_size
        else:
            _, wave_rows = self._plan_waves(q.rows_available())
        smax = 0                 # the ragged step ceiling, a running max
        inflight = None          # _retire's arguments for the wave in flight
        while True:
            with self.tracer.span("wave.admit", wave=st.wave_i):
                # admission at every wave boundary, poll or not: requests
                # another thread submits stream into this drain too
                self._poll_all(poll, host_polls)
                self._admit_new(st, results)
                parts = q.take(wave_rows)
                got = sum(t for _, t, _ in parts)
                if 0 < got < wave_rows:
                    # an open wave: late arrivals get one chance to fill it
                    self._poll_all(poll, host_polls)
                    self._admit_new(st, results)
                    more = q.take(wave_rows - got)
                    parts += more
                    got += sum(t for _, t, _ in more)
            if got == 0:
                break
            # the tail: a snapshot keeps the group's wave size, a stream
            # rounds up to a granule
            target = (-(-got // self.granule) * self.granule if stream
                      else wave_rows)
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
            start = None
            if self.tracer.enabled and self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(self.device))
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
                done = torch.cuda.Event(enable_timing=start is not None)
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
                inflight = (x, done, parts, got, wave, start)
            else:
                self._retire(st, results, x, done, parts, got, wave, start)
        if inflight is not None:
            self._retire(st, results, *inflight)

    def _drain_group_placed(self, grp: _ShardedGroup, st: _DrainState, key,
                            results, *, poll, host_polls, stream):
        """Drain one placed group (grouped classifier-free, or a ragged
        engine's merged group) over the topology, double-buffered like
        ``_drain_group``: each host packs its contiguous window of every
        wave from its own ingress queue (padding and compaction plans per
        window), and the windows read one wave-resident table.  Snapshot
        drains take ``_plan_waves``' near-uniform wave size, streaming ones
        ``wave_size``; either way the wave is split by the hosts' quotas,
        re-read every wave (a lost host's share moves to the survivors)."""
        smax = 0                  # the running step ceiling
        inflight = None           # (outs, inverse orders, placement, parts)
        shapes = set()            # dispatched (host, rows) geometries
        if stream or grp.rows_available() == 0:
            wave_target = self.wave_size
        else:
            _, wave_target = self._plan_waves(grp.rows_available())
        while True:
            topo = self.topology
            quotas = topo.wave_quotas(wave_target)
            with self.tracer.span("wave.admit", wave=st.wave_i):
                self._poll_all(poll, host_polls)
                self._admit_new(st, results)
                parts_h = [q.take(quotas[h])
                           for h, q in enumerate(grp.queues)]
                got = sum(t for parts in parts_h for _, t, _ in parts)
                if 0 < got < sum(quotas):
                    # an open wave: late arrivals get one chance to fill
                    # the hosts' windows before they are padded
                    self._poll_all(poll, host_polls)
                    self._admit_new(st, results)
                    for h, q in enumerate(grp.queues):
                        have = sum(t for _, t, _ in parts_h[h])
                        if have < quotas[h]:
                            parts_h[h] += q.take(quotas[h] - have)
                    got = sum(t for parts in parts_h for _, t, _ in parts)
            if got == 0:
                break
            rows_h = [sum(t for _, t, _ in parts) for parts in parts_h]
            placement = WavePlacement.plan(rows_h, topo.granules)
            if tuple((w.host, w.rows) for w in placement.windows) \
                    not in shapes:
                # a tail wave padded to the quotas takes the full waves'
                # window geometry when one was dispatched (the padding
                # repeats a real row and is discarded)
                quota_pl = WavePlacement.plan(rows_h, topo.granules,
                                              pad_to=quotas)
                if tuple((w.host, w.rows)
                         for w in quota_pl.windows) in shapes:
                    placement = quota_pl
            # the wave index is burnt only when the wave dispatches, and
            # the pack stamps are committed then too: an aborted wave's
            # repack keeps its index and its requests' first pack time
            wave = st.wave_i
            t_pack = self.tracer.now()
            deep = max(p.req.num_steps
                       for parts in parts_h for p, _, _ in parts)
            smax_w = max(smax, deep)
            try:
                xs, invs, host_stats = self._sample_wave_placed(
                    parts_h, placement, key, smax_w, wave=wave)
            except HostLostError as err:
                # failover: retire the wave in flight, put this wave's rows
                # back, move the dead hosts' requests and re-quota; rows
                # are keyed by identity, so the repacked rows are the same
                if inflight is not None:
                    self._retire_placed(st, results, *inflight)
                    inflight = None
                self._handle_host_loss(grp, st, parts_h, err)
                continue
            st.wave_i += 1
            smax = smax_w
            shapes.add(tuple((w.host, w.rows) for w in placement.windows))
            for parts in parts_h:
                for p, _, _ in parts:
                    self.tracer.stamp(p.req.rid, "pack", t=t_pack)
                    self.tracer.stamp(p.req.rid, "dispatch")
            self.metrics.inc("waves")
            if self.ragged:
                self.metrics.inc("merged_waves")
            self.metrics.inc("generated", placement.real_rows)
            self.metrics.inc("scheduled_rows", placement.total_rows)
            self.metrics.inc("padded", placement.padded)
            for w, hs in zip(placement.windows, host_stats):
                h = w.host
                self.metrics.inc("host.rows", w.real, host=h)
                self.metrics.inc("host.padded", w.rows - w.real, host=h)
                self.metrics.inc("host.waves", host=h)
                self.metrics.inc("host.row_iters_scheduled",
                                 hs["scheduled"], host=h)
                self.metrics.inc("host.row_iters_active", hs["active"],
                                 host=h)
                self.metrics.inc("row_iters_scheduled", hs["scheduled"])
                self.metrics.inc("row_iters_active", hs["active"])
            if inflight is not None:
                self._retire_placed(st, results, *inflight)
            if self.async_waves:
                inflight = (xs, invs, placement, parts_h, wave)
            else:
                self._retire_placed(st, results, xs, invs, placement,
                                    parts_h, wave)
        if inflight is not None:
            self._retire_placed(st, results, *inflight)

    def _handle_host_loss(self, grp: _ShardedGroup, st: _DrainState,
                          parts_h, err: HostLostError):
        """Mark the lost hosts failed (survivors re-quota on the next
        wave), put the aborted wave's rows back at the front of their
        queues in pack order, and move each dead host's admitted requests
        onto survivors' queues by identity routing over the live set, in
        every sharded group (a group not yet drained would otherwise keep
        rows no window ever takes).  The rows go back first, so the queues
        stay whole when the last survivor is lost here and
        ``AllHostsLostError`` ends the drain."""
        for hq, parts in zip(grp.queues, parts_h):
            for p, t, _ in parts:
                p.taken -= t
            readd = []
            for p, _, _ in parts:
                if not any(q is p for q in readd) and \
                        not any(q is p for q in hq.items):
                    readd.append(p)
            hq.items.extendleft(reversed(readd))
        for loss in (err, *getattr(err, "also", ())):
            dead = loss.host
            topo = self.topology.mark_failed(dead)   # AllHostsLostError
            self.topology = topo
            self.metrics.inc("fault.host_lost")
            self.metrics.set_gauge("hosts_live", len(topo.live_hosts))
            self.tracer.instant("host.failed", host=dead, wave=loss.wave)
            moved = 0
            for g in st.groups.values():
                if not isinstance(g, _ShardedGroup):
                    continue
                dq = g.queues[dead]
                moved += sum(p.rows_left() for p in dq.items)
                for p in list(dq.items):
                    g.push(p, topo.assign(p.req.rid))
                dq.items.clear()
            self.metrics.inc("failover.requeued_rows", moved)

    def _pack_window(self, w: HostWindow, parts, max_steps: int,
                     total_rows: int, wave: int, mixed: bool = False):
        """Pack one host's window: its rows and per-row meta, its padding,
        and under compaction its epoch plan over its rows sorted by
        activation.  Touches only this host's pendings and this window's
        geometry bucket.
        ``mixed`` is the wave's flag (a classifier-guided row in any
        window).  Returns (rows, meta, inverse order, epochs, stats)."""
        with self.tracer.span("window.pack", wave=wave, **w.span_attrs):
            rows = np.concatenate(
                [p.row_block(t, s, self._null_row if self.ragged else None)
                 for p, t, s in parts])
            # (guidance, steps, rid, row index, mode, classifier slot,
            # label): the single-host packers' row identity
            meta = [(p.req.guidance, p.req.num_steps, p.req.rid,
                     p.req.count - p.fresh + s + i,
                     1.0 if p.req.mode == "clf" else 0.0,
                     (self._clf_slot(p.req.logprob_fn)
                      if p.req.mode == "clf" else 0),
                     p.req.category)
                    for p, t, s in parts for i in range(t)]
            if w.rows > w.real:
                # the window's own last row, identity and all, discarded
                rows = np.concatenate(
                    [rows, np.repeat(rows[-1:], w.rows - w.real, axis=0)])
                meta += [meta[-1]] * (w.rows - w.real)
            active = int(sum(m[1] for m in meta[:w.real]))
            steps_w = np.array([m[1] for m in meta], np.int32)
            if self.compaction is not None:
                seg_granule = (self.topology.granules[w.host]
                               if self.mesh is not None else 1)
                geoms = self._window_geoms.setdefault(
                    (w.offset, total_rows, "mixed") if mixed
                    else (w.offset, total_rows), set())
                order, epochs = plan_epochs(
                    steps_w, max_steps, compaction=self.compaction,
                    granule=seg_granule, geoms=geoms,
                    compile_cost=COMPILE_COST)
                rows = rows[order]
                meta = [meta[i] for i in order]
                inv = np.empty_like(order)
                inv[order] = np.arange(len(order))
            else:
                # one segment over the whole scan, frozen rows riding it
                # as in the one-shot ragged wave
                epochs, inv = ((w.rows, 0, max_steps),), None
            return rows, meta, inv, epochs, \
                {"active": active,
                 "scheduled": sum(r * (e - b) for r, b, e in epochs)}

    def _replica(self, device: torch.device) -> DiT:
        """The DiT on ``device``: the engine's own, or a copy of its
        weights made at first use (a mesh's other data devices)."""
        if device == self.device:
            return self.model
        if device not in self._replicas:
            self._replicas[device] = copy.deepcopy(self.model).to(device)
        return self._replicas[device]

    def _run_chunks(self, lo: int, rows: int, layout: dict, epochs, ctx,
                    wave: int, *, host: int = 0,
                    streams: bool = False) -> _WindowOut:
        """Launch the segment chain of wave rows ``[lo, lo + rows)`` without
        fencing, laid out by ``layout`` (``_layout``): a window whose
        ``window`` operand splits by rows runs one even chunk on each of
        its data devices (the window is rounded to their count), else one
        chunk on the first; each row-split operand hands a chunk its own
        rows, each replicated one its whole wave.  A chunk runs every
        segment of ``epochs`` (prefixes of the rows) that reaches it, on
        its device's replica and, with ``streams``, on the host's stream
        there, which first waits on the wave table's upload.  A chunk's
        update kernels read the wave table at ``row_offset`` = its first
        wave row."""
        cond, row_keys, g, ts, ab_t, ab_prev, jloc, act, _, mx, table, \
            ready = ctx
        H, C = self.image_size, self.channels
        devices = layout["x"].devices
        if not layout["x"].split:
            devices = devices[:1]
        per = rows // len(devices)
        chunks = []
        for i, dev in enumerate(devices):
            c0, c1 = lo + i * per, lo + (i + 1) * per
            model = self._replica(dev)
            side = self._host_stream(host, dev) if streams else None
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                if side is not None:
                    side.wait_event(ready)
                    if side.device == table.device:
                        table.record_stream(side)
                tab = table if table.device == dev else table.to(dev)
                x = torch.zeros((0, H, H, C), device=dev)
                for seg_rows, begin, end in epochs:
                    a, b = c0, min(lo + seg_rows, c1)
                    if b <= a:
                        continue

                    def part(k, v):
                        return v[a:b] if layout[k].split else v

                    args = (model, x, part("y", cond), part("rk", row_keys),
                            part("g", g), part("ts", ts)[:, begin:end],
                            part("jloc", jloc)[:, begin:end],
                            part("ab_t", ab_t)[:, begin:end],
                            part("ab_prev", ab_prev)[:, begin:end],
                            part("act", act)[:, begin:end])
                    kw = dict(row_offset=a, image_size=H, channels=C,
                              coeffs=tab[begin:end])
                    with self.tracer.span("segment.dispatch", host=host,
                                          rows=b - a, begin=begin,
                                          end=end):
                        if mx is None:
                            x = _window_segment(*args, **kw)
                        else:
                            x = _window_segment_mixed(
                                *args, mode=part("mode", mx[0]),
                                clf_ids=part("cids", mx[1]),
                                labels=part("labels", mx[2]),
                                clf_fns=mx[3], **kw)
                x = torch.clamp(x, -1.0, 1.0)
                done = None
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            chunks.append((x, done))
        return _WindowOut(chunks)

    def _dispatch_window(self, w: HostWindow, epochs, ctx,
                         wave: int) -> _WindowOut:
        """Launch one host window's segment chain without fencing, on its
        host's data devices (the engine's device for a simulated host) and
        under ``workers`` on the host's streams.  Its ``window`` fault site
        was checked before any window of the wave launched."""
        B, mx = ctx[8], ctx[9]
        prev = 0
        for rows, begin, end in epochs:
            # the reference's window executable key: the wave's rows, the
            # carried and live rows and the iterations (not the offset)
            self._note_shape(("mixed-win", B, prev, rows, end - begin,
                              len(mx[3])) if mx is not None else
                             ("cfg-win", B, prev, rows, end - begin))
            if self.compaction is not None:
                gk = (w.offset, B, "mixed") if mx is not None \
                    else (w.offset, B)
                self._window_geoms[gk].add((prev, rows, end - begin))
                self.metrics.inc("segments")
            prev = rows
        with self.tracer.span("window.dispatch", wave=wave,
                              segments=len(epochs), **w.span_attrs):
            out = self._run_chunks(w.offset, w.rows,
                                   self._window_shardings(w.host), epochs,
                                   ctx, wave, host=w.host, streams=True)
        if self._sync_hook is not None:
            self._sync_hook("dispatch", w.host, wave)
        return out

    def _wave_ctx(self, cond, meta, key, max_steps: int, mixed: bool,
                  total_rows: int):
        """The wave-resident operands of a row-keyed wave of ``meta``'s
        rows: host rows and tables (``ragged_tables`` over the whole wave)
        and the (S, 8 | 9, B) coefficient table, uploaded once on this
        thread's stream, with the event the windows' streams wait on."""
        g = np.array([m[0] for m in meta], np.float32)
        steps = np.array([m[1] for m in meta], np.int32)
        row_keys = self._row_keys(meta, key)
        ts, ab_t, ab_prev, jloc = ragged_tables(self.sched, steps, max_steps)
        act = jloc >= 0
        mx = None
        if mixed:
            mode, cids, labels = self._mixed_columns(meta)
            mx = (mode, cids, labels, tuple(self._clf_fns))
            table = cfg_ops.mixed_coeffs(mode, g, ab_t.T, ab_prev.T, act.T,
                                         1.0)
        else:
            table = cfg_ops.rowwise_coeffs(g, ab_t.T, ab_prev.T, act.T, 1.0)
        table = torch.as_tensor(table, device=self.device)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return (cond, row_keys, g, ts, ab_t, ab_prev, jloc, act, total_rows,
                mx, table, ready)

    def _sample_wave_placed(self, parts_h, placement: WavePlacement, key,
                            max_steps: int, wave: int = -1):
        """Sample one placed wave: pack every host's window, assemble the
        wave table over the windows in order, check every host's
        ``window`` fault site (all hosts lost in the wave are found, the
        first raised with the others on ``err.also``, before any window
        launches), then launch every window in window order before any
        fence, each reading the table at ``row_offset = window.offset``.
        Returns the windows' outputs, inverse orders and (scheduled,
        active) row-iterations."""
        wins = placement.windows
        mixed = any(p.req.mode == "clf"
                    for parts in parts_h for p, _, _ in parts)
        packed = [self._pack_window(w, parts_h[w.host], max_steps,
                                    placement.total_rows, wave, mixed)
                  for w in wins]
        cond = np.concatenate([p[0] for p in packed])
        ctx = self._wave_ctx(cond, [m for p in packed for m in p[1]], key,
                             max_steps, mixed, placement.total_rows)
        losses = []
        for w in wins:
            try:
                self._check_fault("window", host=w.host, wave=wave)
            except HostLostError as err:
                losses.append(err)
        if losses:
            losses[0].also = losses[1:]
            raise losses[0]
        xs = []
        try:
            for w, p in zip(wins, packed):
                xs.append(self._dispatch_window(w, p[3], ctx, wave))
        except Exception:
            # the launched windows' buffers stay alive until their work
            # is done
            for out in xs:
                out.synchronize()
            raise
        return xs, [p[2] for p in packed], [p[4] for p in packed]

    def _layout(self, mesh) -> dict:
        """Every window operand's ``NamedSharding`` on ``mesh`` by its
        ``wave_window_specs`` entry, under the reference's keys (``x`` the
        image-shaped rows).  The coefficient table built from the
        replicated ``scalar_table`` operands goes whole to every chunk."""
        specs = wave_window_specs(mesh_axes(mesh))
        return {k: NamedSharding(mesh, specs[v]) for k, v in (
            ("x", "window"), ("y", "cond"), ("rk", "row_keys"),
            ("ts", "cond"), ("jloc", "cond"), ("g", "guidance"),
            ("ab_t", "scalar_table"), ("ab_prev", "scalar_table"),
            ("act", "scalar_table"),
            ("mode", "mode"), ("cids", "clf_ids"), ("labels", "labels"))}

    def _window_shardings(self, host: int) -> dict:
        """Host ``host``'s window layout (``_layout``) on its compute mesh
        (``HostTopology.host_mesh``), or for a simulated host on a 1 x 1
        mesh of the engine's device; cached per host."""
        if host not in self._host_shardings:
            sub = self.topology.host_mesh(host)
            if sub is None:
                sub = Mesh(np.array([[self.device]], dtype=object),
                           ("data", "model"))
            self._host_shardings[host] = self._layout(sub)
        return self._host_shardings[host]

    def _fence_window(self, w: HostWindow, out: _WindowOut, wave: int):
        """Wait for one window's work under its host's ``device.scan``
        span."""
        with self.tracer.span("device.scan", host=w.host, rows=w.rows):
            if self._sync_hook is not None:
                self._sync_hook("fence", w.host, wave)
            self._fence(out, host=w.host, wave=wave)

    def _window_rows(self, out: _WindowOut) -> torch.Tensor:
        """A fenced window's rows on the engine's device, marked as used by
        this thread's stream (they were made on a host's stream)."""
        xs = []
        for x, _ in out.chunks:
            if x.is_cuda:
                x.record_stream(torch.cuda.current_stream(x.device))
            xs.append(x.to(self.device))
        return xs[0] if len(xs) == 1 else torch.cat(xs)

    def _retire_placed(self, st: _DrainState, results, xs, invs,
                       placement: WavePlacement, parts_h, wave: int = -1):
        """Fence every window in window order, put compacted windows back
        in pack order, drop each window's padding, and scatter rows to
        their requests in window order."""
        wins = placement.windows
        for w, out in zip(wins, xs):
            self._fence_window(w, out, wave)
        for w, out, inv in zip(wins, xs, invs):
            x = self._window_rows(out)
            if inv is not None:
                x = x[torch.as_tensor(inv, device=x.device)]
            outs = x[:w.real]
            off = 0
            for p, t, _ in parts_h[w.host]:
                p.chunks.append(outs[off:off + t])
                off += t
                if p.done_rows() == p.fresh:
                    self._finalize(st, p, results)

    def _retire(self, st: _DrainState, results, x, done, parts, n_real,
                wave: int = -1, start=None):
        """Wait for the wave's own work, scatter its rows to their
        requests, finalize each request whose rows are complete.  With
        ``start`` (the timed event before the wave's first launch; ``done``
        timed too) record the wave's ``wave.device`` instant."""
        with self.tracer.span("device.scan", host=0, rows=int(x.shape[0])):
            self._fence(done, host=0, wave=wave)
        if start is not None:
            attrs = {"wave": wave, "device_ms": start.elapsed_time(done)}
            if st.last_done is not None:
                attrs["gap_ms"] = st.last_done.elapsed_time(start)
            st.last_done = done
            self.tracer.instant("wave.device", **attrs)
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
