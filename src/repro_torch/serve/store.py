"""Persistent content-addressed D_syn store.

The JAX package's ``serve/store.py`` for the port: the same layout, slugs,
manifest and recovery, so a store written by either package is read by
the other.  ``put`` takes the engine's rows as they come: a tensor on the
card is copied to the host once, at ``put``; ``get`` returns numpy, and
the engine moves a hit to the model's device in one copy.

Spills the SynthesisEngine's (encoding-hash, guidance, steps) output
cache to disk so repeated ``run_oscar`` / ``run_feddisc`` / benchmark
invocations skip synthesis entirely ACROSS PROCESSES — a cold process
pointed at a warm store serves the whole workload with zero sampler
calls and bit-identical rows.

Layout mirrors ``checkpoint/io.py`` (plain npz + JSON manifest,
inspectable with numpy alone)::

    <root>/manifest.json            {"version": 1, "entries": {slug: {...}}}
    <root>/shards/<slug>.npz        {"rows": (count, H, W, C)}

The slug is the CONTENT ADDRESS: sha1 over the cache key — itself the
sha1 of the uploaded encoding bytes plus the guidance scale and step
count — so two stores built from the same uploads share shard names and
a shard can never be served to the wrong request.  Every manifest entry
records count/shape/dtype and is validated against the shard on load;
``put`` buffers in memory and ``flush`` (called by the engine at the end
of every drain) writes dirty shards and rewrites the manifest via a
temp-file rename.

The store does NOT key on the diffusion model's parameters — callers
serving multiple DMs must use one store root per model (see
``core/experiment.py``, which keys the store directory by the DM cache
tag).

DEGRADED OPERATION (``serve/faults.py``): the store is a CACHE, so no
I/O problem is ever worth failing a request over.  Transient read/write
errors retry under the bound ``RetryPolicy``; a shard that stays
unreadable is a miss (re-synthesize); a CORRUPT shard — undecodable
npz, wrong recorded key, structural mismatch vs its manifest entry — is
QUARANTINED: its manifest entry is dropped (rewritten first, same
crash-safe ordering as ``evict``), the file moves to
``<root>/quarantine/`` for post-mortem, and the key misses so the
engine regenerates and the next flush heals the manifest.
``store.quarantined`` / ``store.write_failures`` / ``retry.*`` counters
land on the bound registry.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.faults import (FaultInjector, RetryPolicy,
                                      TransientFaultError)

_VERSION = 1


def _slug(cache_key: tuple) -> str:
    enc_hash, guidance, steps = cache_key
    # repr() is round-trip exact — two distinct guidance floats can never
    # share a slug (get() additionally validates the recorded key)
    raw = f"{enc_hash}|g={float(guidance)!r}|s={int(steps)}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


class SynthesisStore:
    """On-disk companion to the engine's in-memory output cache."""

    def __init__(self, root: str | Path):
        # standalone defaults; ``bind`` swaps in the engine's shared
        # registry/tracer at drain start so store I/O lands on the same
        # timeline and metrics dump as the waves it feeds
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=False)
        self.faults: Optional[FaultInjector] = None
        self.retry = RetryPolicy()
        self.root = Path(root)
        self._shards = self.root / "shards"
        self._rows: dict[str, np.ndarray] = {}      # loaded / pending shards
        self._dirty: set[str] = set()
        self._evicted: set[str] = set()     # tombstones: never merged back
        self._manifest: dict = {"version": _VERSION, "entries": {}}
        mpath = self.root / "manifest.json"
        if mpath.exists():
            self._manifest = json.loads(mpath.read_text())
            if self._manifest.get("version") != _VERSION:
                raise ValueError(
                    f"store {self.root}: unsupported manifest version "
                    f"{self._manifest.get('version')!r}")
        # LRU clock: monotone per-entry access stamps ("lru", absent on
        # pre-eviction manifests → treated as oldest); persisted whenever
        # the manifest is rewritten, so recency survives the process
        self._clock = 1 + max((e.get("lru", 0)
                               for e in self._manifest["entries"].values()),
                              default=0)

    def bind(self, metrics: MetricsRegistry, tracer: Tracer,
             faults: FaultInjector | None = None,
             retry: RetryPolicy | None = None):
        """Adopt the engine's shared metrics registry, tracer, and fault
        policy (injector + retry), so store I/O recovers under the same
        knobs as the drain that drives it."""
        self.metrics = metrics
        self.tracer = tracer
        if faults is not None:
            self.faults = faults
        if retry is not None:
            self.retry = retry

    def _check_fault(self, site: str):
        if self.faults is None:
            return
        try:
            self.faults.check(site)
        except Exception:
            self.metrics.inc("fault.injected", site=site)
            raise

    def _touch(self, slug: str):
        ent = self._manifest["entries"].get(slug)
        if ent is not None:
            ent["lru"] = self._clock
            self._clock += 1

    # -- reads ------------------------------------------------------------
    def get(self, cache_key: tuple) -> Optional[np.ndarray]:
        """All rows stored under ``cache_key``, or None.  Lazy: the shard
        is read (and validated against its manifest entry) on first use.

        A shard SHORTER than its manifest entry — a lost race between
        concurrent same-key flushes — is treated as a miss, not an error:
        the caller re-synthesizes and the next flush heals the entry
        ('costs a re-synthesis, never a wrong result').  A shard LONGER
        than its entry (crash between shard and manifest renames) serves
        the recorded prefix; shards are append-only so the prefix is
        exact.  CORRUPTION — a wrong recorded key, an undecodable npz, a
        row shape/dtype mismatch — never raises: the shard is quarantined
        (manifest healed, file moved to ``quarantine/``) and the key
        misses, so the engine regenerates it.  Transient I/O retries
        under the bound policy; a shard that stays unreadable is a plain
        miss (the file may be fine — don't quarantine it)."""
        s = _slug(cache_key)
        if s in self._rows:
            self._touch(s)
            self.metrics.inc("store.hits")
            return self._rows[s]
        ent = self._manifest["entries"].get(s)
        if ent is None:
            self.metrics.inc("store.misses")
            return None
        enc_hash, guidance, steps = cache_key
        if (ent["key"]["encoding_sha1"] != enc_hash
                or ent["key"]["guidance"] != float(guidance)
                or ent["key"]["steps"] != int(steps)):
            # slugs are content addresses, so a key mismatch means the
            # manifest entry itself is corrupt — never serve it
            self._quarantine(s, "recorded cache key mismatch")
            self.metrics.inc("store.misses")
            return None

        def _read():
            self._check_fault("store.read")
            with np.load(self._shards / f"{s}.npz") as z:
                return z["rows"]

        try:
            t0 = time.perf_counter()
            with self.tracer.span("store.read", track="store", slug=s):
                rows = self.retry.run(_read, metrics=self.metrics,
                                      site="store.read")
            self.metrics.observe("store.read_s", time.perf_counter() - t0)
        except FileNotFoundError:
            # another handle evicted the shard after we read the manifest
            # — a miss, not corruption: re-synthesize and heal
            self.metrics.inc("store.misses")
            return None
        except (TransientFaultError, OSError):
            # unreadable even after retries: miss, but the file may be
            # fine (flaky media) — leave it in place
            self.metrics.inc("store.misses")
            return None
        except Exception as exc:
            # np.load decode failure — a torn or garbage shard file
            self._quarantine(s, f"undecodable shard: {exc!r}")
            self.metrics.inc("store.misses")
            return None
        if (list(rows.shape[1:]) != list(ent["shape"])[1:]
                or str(rows.dtype) != ent["dtype"]):
            self._quarantine(
                s, f"shape {list(rows.shape)}/{ent['shape']} dtype "
                   f"{rows.dtype}/{ent['dtype']} mismatch")
            self.metrics.inc("store.misses")
            return None
        if len(rows) < ent["count"]:
            self.metrics.inc("store.misses")
            return None                     # lost flush race: re-synthesize
        self._rows[s] = rows = rows[:ent["count"]]
        self._touch(s)
        self.metrics.inc("store.hits")
        return rows

    def _quarantine(self, slug: str, reason: str):
        """Contain a corrupt shard: drop its manifest entry and every
        in-memory trace, tombstone it (a concurrent flush must not
        resurrect the entry), rewrite the manifest, and only THEN move
        the file into ``quarantine/`` — the same manifest-before-file
        ordering ``evict`` uses, so a crash mid-quarantine strands at
        worst an orphaned shard file, never a dangling manifest entry.
        A later ``put`` on the key regenerates cleanly (it clears the
        tombstone and heals the manifest)."""
        self._manifest["entries"].pop(slug, None)
        self._rows.pop(slug, None)
        self._dirty.discard(slug)
        self._evicted.add(slug)
        self.metrics.inc("store.quarantined")
        self.tracer.instant("store.quarantine", track="store", slug=slug,
                            reason=reason)
        self._write_manifest()
        src = self._shards / f"{slug}.npz"
        if src.exists():
            qdir = self.root / "quarantine"
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(src, qdir / f"{slug}.npz")

    def __contains__(self, cache_key: tuple) -> bool:
        return _slug(cache_key) in self._manifest["entries"]

    def __len__(self) -> int:
        return len(self._manifest["entries"])

    # -- writes -----------------------------------------------------------
    def put(self, cache_key: tuple, rows: np.ndarray):
        """Record the full row set for ``cache_key`` (the engine always
        hands the merged cache entry, so a put only ever grows a shard).
        Buffered until ``flush``."""
        s = _slug(cache_key)
        have = self._rows.get(s)
        if have is not None and len(have) > len(rows):
            return                      # never shrink a shard
        if hasattr(rows, "detach"):     # a torch tensor: one host copy
            rows = rows.detach().cpu().numpy()
        rows = np.asarray(rows)
        self._rows[s] = rows
        self._dirty.add(s)
        self._evicted.discard(s)            # re-putting resurrects the key
        enc_hash, guidance, steps = cache_key
        self._manifest["entries"][s] = {
            "key": {"encoding_sha1": enc_hash, "guidance": float(guidance),
                    "steps": int(steps)},
            "count": int(len(rows)),
            "shape": [int(d) for d in rows.shape],
            "dtype": str(rows.dtype),
            "file": f"shards/{s}.npz",
        }
        self._touch(s)

    def flush(self):
        """Write dirty shards, then rewrite the manifest.  Both go through
        temp + rename, shards strictly before the manifest, so a crash at
        any point leaves every manifest entry pointing at a shard holding
        at least its recorded rows (``get`` serves the manifest prefix).

        The on-disk manifest is re-read and merged before the rewrite —
        entries another process flushed since we opened the store are
        kept (our own dirty keys win), so concurrent processes sharing a
        root extend rather than erase each other.  The merge is
        best-effort (read-merge-write without a lock): simultaneous
        flushes can still lose the race for non-overlapping keys, which
        costs a re-synthesis, never a wrong result."""
        if not self._dirty:
            return
        self._shards.mkdir(parents=True, exist_ok=True)
        written = set()
        with self.tracer.span("store.flush", track="store",
                              shards=len(self._dirty)):
            for s in sorted(self._dirty):
                # pid-suffixed like the manifest tmp: concurrent flushes
                # must never interleave writes into one tmp and publish a
                # torn npz
                def _write(s=s):
                    self._check_fault("store.write")
                    tmp = self._shards / f"{s}.{os.getpid()}.tmp"
                    with open(tmp, "wb") as f:
                        np.savez(f, rows=self._rows[s])
                    os.replace(tmp, self._shards / f"{s}.npz")

                t0 = time.perf_counter()
                try:
                    with self.tracer.span("store.write", track="store",
                                          slug=s):
                        self.retry.run(_write, metrics=self.metrics,
                                       site="store.write")
                except Exception:
                    # degraded, not fatal: the shard stays dirty (and in
                    # memory) for the next flush; serving continues.  If
                    # its manifest entry lands without the shard, readers
                    # see FileNotFoundError — a miss, never a wrong row.
                    self.metrics.inc("store.write_failures")
                    continue
                written.add(s)
                self.metrics.observe("store.write_s",
                                     time.perf_counter() - t0)
            self._write_manifest()
        self._dirty -= written

    def _write_manifest(self):
        """Merge-then-rewrite via temp + rename.  Entries another process
        flushed since we opened the store are kept (our dirty keys win)
        UNLESS this handle evicted them — tombstones stop a concurrent
        flush from resurrecting a shard whose file we deleted."""
        mpath = self.root / "manifest.json"
        if mpath.exists():
            try:
                disk = json.loads(mpath.read_text()).get("entries", {})
            except (json.JSONDecodeError, OSError):
                disk = {}
            ours = self._manifest["entries"]
            for s, ent in disk.items():
                if s not in self._dirty and s not in ours \
                        and s not in self._evicted:
                    ours[s] = ent
        tmp = self.root / f"manifest.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps(self._manifest, indent=1))
        os.replace(tmp, mpath)

    # -- eviction ---------------------------------------------------------
    @staticmethod
    def _entry_bytes(ent: dict) -> int:
        return int(np.prod(ent["shape"]) * np.dtype(ent["dtype"]).itemsize)

    def total_bytes(self) -> int:
        """Row bytes recorded in the manifest (uncompressed; the budget's
        accounting unit — stable across npz compression ratios)."""
        return sum(self._entry_bytes(e)
                   for e in self._manifest["entries"].values())

    def evict(self, max_bytes: int) -> list[str]:
        """Evict least-recently-used shards until ``total_bytes() <=
        max_bytes``.  Returns the evicted slugs (empty when under budget).

        Ordering is crash-safe for the manifest invariant ('every entry
        points at a shard holding at least its recorded rows'): entries
        leave the manifest — rewritten via temp + rename — BEFORE their
        shard files are unlinked, so a crash mid-evict strands at worst
        an orphaned shard file, never a dangling manifest entry.  An
        evicted key simply misses and re-synthesizes."""
        entries = self._manifest["entries"]
        total = self.total_bytes()
        if total <= max_bytes:
            return []
        # publish pending shards first: the manifest rewrite below must
        # never expose a dirty entry whose shard is not on disk yet
        self.flush()
        victims = []
        for s, ent in sorted(entries.items(),
                             key=lambda kv: kv[1].get("lru", 0)):
            if total <= max_bytes:
                break
            total -= self._entry_bytes(ent)
            victims.append(s)
        self.metrics.inc("store.evictions", len(victims))
        for s in victims:
            entries.pop(s)
            self._rows.pop(s, None)
            self._dirty.discard(s)
            self._evicted.add(s)
        self._write_manifest()
        for s in victims:
            try:
                (self._shards / f"{s}.npz").unlink()
            except FileNotFoundError:
                pass                    # never flushed, or already gone
        return victims
