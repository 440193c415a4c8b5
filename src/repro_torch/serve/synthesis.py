"""Batched D_syn synthesis: wave-scheduled classifier-free sampling.

``SynthesisEngine`` turns queued requests, each (encoding, category,
count, guidance, steps), into sampler waves and hands every request its
rows back.  A ``run`` drains the queue as it stands (a snapshot drain):

* requests are grouped by (guidance, steps), or all into one group when
  the engine is ragged, and groups drain in sorted order;
* a group of N rows is packed FIFO into near-uniform waves: one wave size
  ``w = ceil(N / ceil(N / wave_size) / 8) * 8``, a short last
  wave padded by repeating its last row (the padding is discarded);
* wave ``i`` of the drain, counted across groups, samples a grouped wave
  with ``sample_cfg(fold_in(key, i))``;
* a ragged wave gives every row its own (guidance, steps) and its own
  noise key, ``fold_in(fold_in(key, rid), row_index)``, so a row's value
  does not depend on how it was packed.  Its step ceiling is the running
  maximum over the group's waves.  With ``compaction`` the wave runs as
  nested activation epochs (``plan_epochs``), so frozen rows stop riding
  the denoiser; the rows' values stay those of the one-shot ragged wave.

``stats`` counts the device work.  ``generated`` counts real rows,
``scheduled_rows`` every row on the device (``generated + padded``), and
``row_iters_scheduled`` against ``row_iters_active`` the denoiser rows
run against those a real row needed.

The engine has no row cache: a request that repeats the (encoding,
guidance, steps) of one already taken by this engine raises
``NotImplementedError``, since a caching engine would serve it from the
first one's rows.  Streaming admission, stores, tracing, fault handling,
host topologies and the classifier-guided and unconditional modes are
not part of this engine.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import plan_epochs
from repro_torch.diffusion.sampler import (sample_cfg, sample_cfg_compacted,
                                           sample_cfg_ragged)
from repro_torch.diffusion.schedule import NoiseSchedule

STAT_KEYS = ("waves", "generated", "scheduled_rows", "padded",
             "merged_waves", "segments", "row_iters_scheduled",
             "row_iters_active")
GRANULE = 8               # wave rows round up to a multiple of this
COMPILE_COST = 256        # "auto" compaction's price of a new segment shape


@dataclass
class SynthesisRequest:
    rid: int
    count: int
    category: int
    guidance: float
    num_steps: int
    cond: np.ndarray               # (cond_dim,) float32

    @property
    def identity(self) -> tuple:
        """(encoding hash, guidance, steps): the key a caching engine
        would serve repeats of this request from."""
        digest = hashlib.sha1(self.cond.tobytes()).hexdigest()
        return digest, self.guidance, self.num_steps


class SynthesisEngine:
    """Wave-based batched classifier-free synthesis over a frozen DiT, on
    the model's device."""

    def __init__(self, model: DiT, sched: NoiseSchedule, *, image_size: int,
                 channels: int = 3, wave_size: int = 128, ragged: bool = False,
                 compaction: int | str | None = None):
        """``compaction`` is ``"full"``, ``"auto"`` or an int K >= 1 (see
        ``plan_epochs``), and implies ``ragged``."""
        if compaction is not None and compaction not in ("full", "auto") and (
                not isinstance(compaction, int) or isinstance(compaction, bool)
                or compaction < 1):
            raise ValueError(f"compaction={compaction!r}: expected 'full', "
                             f"'auto', or an int K >= 1")
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
        # plan_epochs' "auto" mode treats a split into one of them as free
        self._segment_geoms: set[tuple] = set()

    def submit(self, encoding, category: int, count: int, *,
               guidance: float | None = None,
               num_steps: int | None = None) -> int:
        """Queue ``count`` samples of one classifier-free conditioning row
        (paper Eq. 8/9).  Returns the request id; ids count up in
        submission order."""
        enc = np.ascontiguousarray(encoding, np.float32)
        if enc.ndim != 1:
            raise ValueError(f"encoding must be one (cond_dim,) row, got "
                             f"shape {enc.shape}")
        dc = self.model.dc
        req = SynthesisRequest(
            rid=self._next_rid, count=int(count), category=int(category),
            guidance=(dc.guidance_scale if guidance is None
                      else float(guidance)),
            num_steps=int(num_steps or dc.sample_timesteps), cond=enc)
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    def run(self, key) -> dict[int, torch.Tensor]:
        """Drain the queue with the threefry ``key``.  Returns rid →
        (count, H, W, C) images on the model's device."""
        key = np.asarray(key, np.uint32)
        ids = [r.identity for r in self._queue]
        if len(set(ids)) < len(ids) or self._taken.intersection(ids):
            raise NotImplementedError(
                "two requests share (encoding, guidance, steps); the "
                "reference serves the second from the first one's rows, "
                "and this engine has no row cache")
        results: dict[int, torch.Tensor] = {}
        groups: dict[tuple, list[SynthesisRequest]] = {}
        for r in self._queue:
            if r.count <= 0:
                results[r.rid] = torch.zeros(
                    (0, self.image_size, self.image_size, self.channels),
                    device=self.model.null_y.device)
                continue
            gk = () if self.ragged else (r.guidance, r.num_steps)
            groups.setdefault(gk, []).append(r)
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

    def _drain_group(self, reqs, key, wave_i: int, results) -> int:
        """Drain one group wave by wave; returns the next wave index."""
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
            cond = np.concatenate([np.repeat(r.cond[None], t, axis=0)
                                   for r, _, t in parts])
            # rows as (guidance, steps, rid, row index); padding repeats
            # the last row, identity and all, and is discarded
            meta = [(r.guidance, r.num_steps, r.rid, s + i)
                    for r, s, t in parts for i in range(t)]
            meta += [meta[-1]] * room
            cond = np.concatenate([cond, np.repeat(cond[-1:], room, axis=0)])
            if self.ragged:
                smax = max(smax, max(m[1] for m in meta))
                x, sched_iters = self._sample_ragged(cond, meta, key, smax)
                active_iters = sum(m[1] for m in meta[:got])
                self.stats["merged_waves"] += 1
            else:
                head = parts[0][0]
                x = sample_cfg(self.model, self.sched, cond,
                               prng.fold_in(key, wave_i),
                               image_size=self.image_size,
                               channels=self.channels,
                               num_steps=head.num_steps,
                               guidance=head.guidance)
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

    def _sample_ragged(self, cond, meta, key, max_steps: int):
        """One ragged wave, one-shot or compacted.  Returns (images,
        scheduled row-iterations, padding included)."""
        g = np.array([m[0] for m in meta], np.float32)
        steps = np.array([m[1] for m in meta], np.int32)
        rids = np.array([m[2] for m in meta], np.int64)
        ridx = np.array([m[3] for m in meta], np.int64)
        row_keys = prng.fold_in(prng.fold_in(key[None], rids), ridx)
        kw = dict(max_steps=max_steps, image_size=self.image_size,
                  channels=self.channels)
        if self.compaction is None:
            x = sample_cfg_ragged(self.model, self.sched, cond, row_keys, g,
                                  steps, **kw)
            return x, len(meta) * max_steps
        plan = plan_epochs(steps, max_steps, compaction=self.compaction,
                           geoms=self._segment_geoms,
                           compile_cost=COMPILE_COST)
        prev = 0
        for rows, begin, end in plan[1]:
            self._segment_geoms.add((prev, rows, end - begin))
            prev = rows
        self.stats["segments"] += len(plan[1])
        x = sample_cfg_compacted(self.model, self.sched, cond, row_keys, g,
                                 steps, plan=plan, **kw)
        return x, sum(rows * (end - begin) for rows, begin, end in plan[1])
