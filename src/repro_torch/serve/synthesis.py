"""Batched D_syn synthesis: wave-scheduled diffusion sampling.

``SynthesisEngine`` turns queued requests into sampler waves and hands
every request its rows back.  A request is classifier-free (``submit``:
an encoding, paper Eq. 8/9, or one distinct conditioning row per sample
as a 2-D ``(count, cond_dim)`` encoding, FedDISC's resampled statistics),
classifier-guided (``submit_classifier_guided``:
a client classifier's log p(y|x) and a category, Eq. 4 / FedCADO) or
unconditional (``submit_unconditional``: draws through the null
embedding, FedDISC-style).  A ``run`` drains the queue as it stands (a
snapshot drain):

* requests are grouped by (mode, guidance, steps), classifier-guided ones
  also by their ``group`` (one uploaded classifier), or all into one group
  when the engine is ragged, and groups drain in sorted order;
* a group of N rows is packed FIFO into near-uniform waves: one wave size
  ``w = ceil(N / ceil(N / wave_size) / 8) * 8``, a short last
  wave padded by repeating its last row (the padding is discarded);
* wave ``i`` of the drain, counted across groups, samples a grouped wave
  from ``fold_in(key, i)``: ``sample_cfg``, ``sample_classifier_guided``
  (its rows' categories are the labels, the group's first request's
  classifier guides) or ``sample_uncond``;
* a ragged wave gives every row its own (guidance, steps) and its own
  noise key, ``fold_in(fold_in(key, rid), row_index)``, so a row's value
  does not depend on how it was packed.  Its step ceiling is the running
  maximum over the group's waves.  With ``compaction`` the wave runs as
  nested activation epochs (``plan_epochs``), so frozen rows stop riding
  the denoiser; the rows' values stay those of the one-shot ragged wave;
* in a ragged wave an unconditional row is a classifier-free row with
  guidance 0 on the null embedding, and a classifier-guided row carries
  the null embedding, its category and a slot in the engine's classifier
  registry (classifiers match by identity).  A wave that holds a
  classifier-guided row runs ``sample_mixed`` (``cfg_update_mixed``);
  any other wave keeps ``sample_cfg_ragged`` (``cfg_update_rowwise``).

``stats`` counts the device work.  ``generated`` counts real rows,
``scheduled_rows`` every row on the device (``generated + padded``), and
``row_iters_scheduled`` against ``row_iters_active`` the denoiser rows
run against those a real row needed.

The engine has no row cache: a request that repeats the cache key of
one already taken by this engine raises ``NotImplementedError``, since a
caching engine would serve it from the first one's rows.  The key is
(digest of the encoding's rows, guidance, steps) for a classifier-free
request and
(``"uncond:<category>"``, 0.0, steps) for an unconditional one;
classifier-guided requests have none and are never refused.  Streaming
admission, stores, tracing, fault handling and host topologies are not
part of this engine.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

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

STAT_KEYS = ("waves", "generated", "scheduled_rows", "padded",
             "merged_waves", "segments", "row_iters_scheduled",
             "row_iters_active")
GRANULE = 8               # wave rows round up to a multiple of this
COMPILE_COST = 256        # "auto" compaction's price of a new segment shape


def _check_compaction(compaction) -> None:
    if compaction is not None and compaction not in ("full", "auto") and (
            not isinstance(compaction, int) or isinstance(compaction, bool)
            or compaction < 1):
        raise ValueError(f"compaction={compaction!r}: expected 'full', "
                         f"'auto', or an int K >= 1")


@dataclass
class SynthesisRequest:
    rid: int
    mode: str                      # "cfg" | "clf" | "uncond"
    count: int
    category: int
    guidance: float
    num_steps: int
    cond: np.ndarray | None = None         # (cond_dim,) or (count, cond_dim)
    logprob_fn: Callable | None = None     # for mode "clf"
    group: Any = None                      # wave affinity for mode "clf"

    @property
    def identity(self) -> tuple | None:
        """The key a caching engine would serve repeats of this request
        from: (encoding hash, guidance, steps), a per-category key for an
        unconditional request, None for a classifier-guided one."""
        if self.mode == "cfg":
            digest = hashlib.sha1(self.cond.tobytes()).hexdigest()
            return digest, self.guidance, self.num_steps
        if self.mode == "uncond":
            return f"uncond:{self.category}", 0.0, self.num_steps
        return None

    def group_key(self, ragged: bool) -> tuple:
        if ragged:
            return ("cfg",)
        clf = ("clf", repr(self.group)) if self.mode == "clf" else ("", "")
        return (self.mode, self.guidance, self.num_steps) + clf


class SynthesisEngine:
    """Wave-based batched synthesis over a frozen DiT, on the model's
    device."""

    def __init__(self, model: DiT, sched: NoiseSchedule, *, image_size: int,
                 channels: int = 3, wave_size: int = 128, ragged: bool = False,
                 compaction: int | str | None = None):
        """``compaction`` is ``"full"``, ``"auto"`` or an int K >= 1 (see
        ``plan_epochs``), and implies ``ragged``."""
        _check_compaction(compaction)
        self.model, self.sched = model, sched
        self.image_size, self.channels = image_size, channels
        self.wave_size = max(-(-wave_size // GRANULE) * GRANULE, GRANULE)
        self.ragged = ragged or compaction is not None
        self.compaction = compaction
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        self._queue: list[SynthesisRequest] = []
        self._next_rid = 0
        self._taken: set[tuple] = set()   # identities of drained requests
        # segment geometries (carried, rows, iterations) planned so far:
        # plan_epochs' "auto" mode treats a split into one of them as free.
        # Mixed waves keep their own, as the reference's engine does.
        self._segment_geoms: set[tuple] = set()
        self._segment_geoms_mixed: set[tuple] = set()
        # classifiers of ragged waves, by identity, in order of first use;
        # a classifier-guided row selects its own by slot
        self._clf_fns: list = []
        self._null_row = model.null_y.detach().cpu().numpy()

    def submit(self, encoding, category: int, count: int | None = None, *,
               guidance: float | None = None,
               num_steps: int | None = None) -> int:
        """Queue a classifier-free request (paper Eq. 8/9): ``count``
        samples of one conditioning row (a 1-D encoding), or one sample of
        each row of a 2-D ``(count, cond_dim)`` encoding (FedDISC's
        resampled statistics), one request and one identity.  Returns the
        request id; ids count up in submission order."""
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
        return self._push(mode="cfg", count=count, category=category,
                          guidance=g, num_steps=steps, cond=enc)

    def opt_in(self, *, ragged: bool = False,
               compaction: int | str | None = None) -> "SynthesisEngine":
        """Switch this engine to ragged waves (``ragged=True``) or to
        compacted ones (``compaction``), never back: ``ragged=False`` and
        ``compaction=None`` leave it as it is.  Returns the engine."""
        _check_compaction(compaction)
        if compaction is not None:
            self.compaction = compaction
        self.ragged = self.ragged or ragged or compaction is not None
        return self

    def submit_classifier_guided(self, logprob_fn, category: int, count: int,
                                 *, guidance: float | None = None,
                                 num_steps: int | None = None,
                                 group: Any = None) -> int:
        """Queue ``count`` classifier-guided samples of ``category`` (Eq. 4 /
        FedCADO): ``logprob_fn(x, labels) -> (B,)`` log p(y|x), for instance
        ``models.classifiers.classifier_logprob(model)``.  ``group`` is the
        wave affinity of grouped waves: requests sharing it (one uploaded
        classifier) batch together, and the first one's classifier guides
        the wave.  By default every request is its own group."""
        g, steps = self._resolve(guidance, num_steps)
        return self._push(mode="clf", count=count, category=category,
                          guidance=g, num_steps=steps, logprob_fn=logprob_fn,
                          group=(group if group is not None
                                 else ("anon", self._next_rid)))

    def submit_unconditional(self, count: int, *, category: int = -1,
                             num_steps: int | None = None) -> int:
        """Queue ``count`` unguided draws from the DM's p(x), through the
        null embedding.  ``category`` only labels the rows (and keys the
        request, as the reference's cache does)."""
        _, steps = self._resolve(0.0, num_steps)
        return self._push(mode="uncond", count=count, category=category,
                          guidance=0.0, num_steps=steps)

    def _resolve(self, guidance, num_steps):
        dc = self.model.dc
        g = dc.guidance_scale if guidance is None else float(guidance)
        return g, int(num_steps or dc.sample_timesteps)

    def _push(self, *, count, category, **fields) -> int:
        req = SynthesisRequest(rid=self._next_rid, count=int(count),
                               category=int(category), **fields)
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    def run(self, key) -> dict[int, torch.Tensor]:
        """Drain the queue with the threefry ``key``.  Returns rid →
        (count, H, W, C) images on the model's device."""
        key = np.asarray(key, np.uint32)
        ids = [r.identity for r in self._queue if r.identity is not None]
        if len(set(ids)) < len(ids) or self._taken.intersection(ids):
            raise NotImplementedError(
                "two requests share a cache key ((encoding, guidance, "
                "steps), or category and steps of unconditional draws); "
                "the reference serves the second from the first one's "
                "rows, and this engine has no row cache")
        results: dict[int, torch.Tensor] = {}
        groups: dict[tuple, list[SynthesisRequest]] = {}
        for r in self._queue:
            if r.count <= 0:
                results[r.rid] = torch.zeros(
                    (0, self.image_size, self.image_size, self.channels),
                    device=self.model.null_y.device)
                continue
            groups.setdefault(r.group_key(self.ragged), []).append(r)
        wave_i = 0
        for gk in sorted(groups):
            wave_i = self._drain_group(groups[gk], key, wave_i, results)
        self._taken.update(ids)
        self._queue.clear()
        return results

    def _wave_rows(self, n: int) -> int:
        """Rows per wave for a group of n: near-uniform waves, padding
        under one granule per wave."""
        per_wave = -(-n // -(-n // self.wave_size))
        return -(-per_wave // GRANULE) * GRANULE

    def _clf_slot(self, fn) -> int:
        """Slot of ``fn`` in the classifier registry (identity match),
        appended at first sight."""
        for i, f in enumerate(self._clf_fns):
            if f is fn:
                return i
        self._clf_fns.append(fn)
        return len(self._clf_fns) - 1

    def _cond_rows(self, r: SynthesisRequest, start: int, t: int):
        """Conditioning rows ``start:start + t`` of ``r``: a 2-D encoding's
        own rows, a 1-D encoding repeated, or (in a ragged wave) the null
        embedding for classifier-guided and unconditional rows."""
        if r.mode == "cfg" and r.cond.ndim == 2:
            return r.cond[start:start + t]
        row = r.cond if r.mode == "cfg" else self._null_row
        return np.repeat(row[None], t, axis=0)

    def _drain_group(self, reqs, key, wave_i: int, results) -> int:
        """Drain one group wave by wave; returns the next wave index."""
        head = reqs[0]
        wave_rows = self._wave_rows(sum(r.count for r in reqs))
        pending = deque([r, 0] for r in reqs)     # (request, rows taken)
        chunks: dict[int, list] = {r.rid: [] for r in reqs}
        smax = 0
        while pending:
            parts = []                            # (request, start, rows)
            room = wave_rows
            while room and pending:
                r, start = pending[0]
                t = min(r.count - start, room)
                parts.append((r, start, t))
                room -= t
                if start + t == r.count:
                    pending.popleft()
                else:
                    pending[0][1] += t
            got = wave_rows - room
            # rows as (guidance, steps, rid, row index, mode, classifier
            # slot, label); padding repeats the last row, identity and all,
            # and is discarded
            meta = [(r.guidance, r.num_steps, r.rid, s + i,
                     1.0 if r.mode == "clf" else 0.0,
                     self._clf_slot(r.logprob_fn) if r.mode == "clf" else 0,
                     r.category)
                    for r, s, t in parts for i in range(t)]
            meta += [meta[-1]] * room
            if self.ragged:
                cond = np.concatenate([self._cond_rows(r, s, t)
                                       for r, s, t in parts])
                cond = np.concatenate([cond, np.repeat(cond[-1:], room,
                                                       axis=0)])
                smax = max(smax, max(m[1] for m in meta))
                x, sched_iters = self._sample_ragged(cond, meta, key, smax)
                active_iters = sum(m[1] for m in meta[:got])
                self.stats["merged_waves"] += 1
            else:
                x = self._sample_grouped(head, parts, meta, room,
                                         prng.fold_in(key, wave_i))
                sched_iters = wave_rows * head.num_steps
                active_iters = got * head.num_steps
            wave_i += 1
            self.stats["waves"] += 1
            self.stats["generated"] += got
            self.stats["scheduled_rows"] += wave_rows
            self.stats["padded"] += room
            self.stats["row_iters_scheduled"] += int(sched_iters)
            self.stats["row_iters_active"] += int(active_iters)
            off = 0
            for r, s, t in parts:
                chunks[r.rid].append(x[off:off + t])
                off += t
                if s + t == r.count:
                    results[r.rid] = torch.cat(chunks.pop(r.rid))
        return wave_i

    def _sample_grouped(self, head: SynthesisRequest, parts, meta, room: int,
                        key):
        """One grouped wave of ``head``'s mode from the wave key."""
        kw = dict(image_size=self.image_size, channels=self.channels,
                  num_steps=head.num_steps)
        if head.mode == "cfg":
            cond = np.concatenate([self._cond_rows(r, s, t)
                                   for r, s, t in parts])
            cond = np.concatenate([cond, np.repeat(cond[-1:], room, axis=0)])
            return sample_cfg(self.model, self.sched, cond, key,
                              guidance=head.guidance, **kw)
        if head.mode == "clf":
            labels = np.array([m[6] for m in meta], np.int64)
            return sample_classifier_guided(
                self.model, self.sched, head.logprob_fn, labels, key,
                guidance=head.guidance, **kw)
        return sample_uncond(self.model, self.sched, len(meta), key, **kw)

    def _sample_ragged(self, cond, meta, key, max_steps: int):
        """One ragged wave, one-shot or compacted, mixed when it holds a
        classifier-guided row.  Returns (images, scheduled row-iterations,
        padding included)."""
        g = np.array([m[0] for m in meta], np.float32)
        steps = np.array([m[1] for m in meta], np.int32)
        rids = np.array([m[2] for m in meta], np.int64)
        ridx = np.array([m[3] for m in meta], np.int64)
        mode = np.array([m[4] for m in meta], np.float32)
        row_keys = prng.fold_in(prng.fold_in(key[None], rids), ridx)
        mixed = bool(mode.any())
        kw = dict(max_steps=max_steps, image_size=self.image_size,
                  channels=self.channels)
        ops = ()
        if mixed:
            ops = (mode, np.array([m[5] for m in meta], np.int64),
                   np.array([m[6] for m in meta], np.int64))
            kw["clf_fns"] = tuple(self._clf_fns)
        if self.compaction is None:
            sampler = sample_mixed if mixed else sample_cfg_ragged
            x = sampler(self.model, self.sched, cond, row_keys, g, *ops,
                        steps, **kw)
            return x, len(meta) * max_steps
        geoms = self._segment_geoms_mixed if mixed else self._segment_geoms
        plan = plan_epochs(steps, max_steps, compaction=self.compaction,
                           geoms=geoms, compile_cost=COMPILE_COST)
        prev = 0
        for rows, begin, end in plan[1]:
            geoms.add((prev, rows, end - begin))
            prev = rows
        self.stats["segments"] += len(plan[1])
        sampler = sample_mixed_compacted if mixed else sample_cfg_compacted
        x = sampler(self.model, self.sched, cond, row_keys, g, *ops, steps,
                    plan=plan, **kw)
        return x, sum(rows * (end - begin) for rows, begin, end in plan[1])
