"""Batched LM serving engine: the JAX package's ``serve/engine.py``.

Requests are grouped into WAVES of equal prompt length; each wave
prefills as one batch and decodes in lockstep (one decode step per tick
for the whole wave), finishing when every member hits its token budget or
EOS.  Lockstep waves keep the single-position decode step exact.

The model runs where its parameters are (the card unless it was built
with ``device="cpu"``); prefill attention goes through the flash-attention
kernel unless ``par.use_kernels`` is off, and decode attention is plain.

``tracer`` (``obs/trace.py``; the process default when not given) is
current while ``run`` drains, so the LM's layers open their spans on it.
Each wave is a ``serve.wave`` span (``B``, ``L``) holding
``serve.prefill`` (the LM forward), ``serve.pad_caches``,
``serve.first_token`` (the argmax and its read to the host, the wave's
sync) and one ``serve.decode_step`` a decode step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, default, using
from repro_torch.serve.steps import make_serve_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new: int = 32
    eos: Optional[int] = None
    out: list = field(default_factory=list)


class ServeEngine:
    """Wave-based batched generation."""

    _STAT_KEYS = ("waves", "prefilled", "decoded")

    def __init__(self, cfg: ModelConfig, lm: LM, *, max_len: int = 256,
                 par: Parallel = Parallel(),
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        assert cfg.supports_decode, f"{cfg.name} is encoder-only"
        self.cfg, self.lm, self.par = cfg, lm, par
        self.max_len = max_len
        self._decode = make_serve_step(lm, par)
        self._queue: list[Request] = []
        self._next_rid = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else default()

    @property
    def stats(self) -> dict:
        """Dict view over the metrics registry (the reference's keys)."""
        return {k: self.metrics.get(k) for k in self._STAT_KEYS}

    def submit(self, prompt, max_new: int = 32, eos: int | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt, np.int32),
                                   max_new, eos))
        return rid

    def run(self) -> dict[int, list[int]]:
        """Drain the queue.  Returns rid -> generated token ids."""
        results: dict[int, list[int]] = {}
        with using(self.tracer):
            while self._queue:
                # wave = all queued requests sharing the front prompt length
                L = len(self._queue[0].prompt)
                wave = [r for r in self._queue if len(r.prompt) == L]
                self._queue = [r for r in self._queue if len(r.prompt) != L]
                self._run_wave(wave, results)
        return results

    # -- internals --------------------------------------------------------
    def _pad_caches(self, caches, B: int, L: int):
        """The prefill's (B, L, ...) KV caches copied into zero caches of
        max_len positions, as the reference pads them; recurrent states
        (Mamba, mLSTM, sLSTM) pass through."""
        def pad(c):
            if not isinstance(c, KVCache):
                return c
            full = KVCache(*(t.new_zeros((B, self.max_len, *t.shape[2:]))
                             for t in c))
            full.k[:, :L] = c.k
            full.v[:, :L] = c.v
            return full
        return [pad(c) for c in caches]

    @torch.inference_mode()
    def _run_wave(self, wave, results):
        tr = self.tracer
        L = len(wave[0].prompt)
        budget = max(r.max_new for r in wave)
        assert L + budget <= self.max_len, "wave exceeds engine max_len"
        with tr.span("serve.wave", B=len(wave), L=L):
            toks = torch.as_tensor(np.stack([r.prompt for r in wave]),
                                   device=self.lm.device)
            with tr.span("serve.prefill"):
                logits, _, caches = self.lm(toks, self.par, mode="prefill")
            with tr.span("serve.pad_caches"):
                caches = self._pad_caches(caches, len(wave), L)
            self.metrics.inc("waves")
            self.metrics.inc("prefilled", len(wave))
            with tr.span("serve.first_token"):
                cur = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                                   -1)[:, None].to(torch.int32)
                first = cur[:, 0].tolist()
            done = [False] * len(wave)
            for r, t in zip(wave, first):
                r.out.append(int(t))
            for i in range(budget - 1):
                with tr.span("serve.decode_step"):
                    cur, _, caches = self._decode(cur, caches, L + i)
                    toks_np = (np.asarray(cur[:, 0].cpu())
                               % self.cfg.vocab_size)
                self.metrics.inc("decoded", len(wave))
                for j, (r, t) in enumerate(zip(wave, toks_np)):
                    if done[j]:
                        continue
                    r.out.append(int(t))
                    if len(r.out) >= r.max_new or (r.eos is not None
                                                   and int(t) == r.eos):
                        done[j] = True
                        results[r.rid] = r.out
                if all(done):
                    break
        for j, r in enumerate(wave):
            if not done[j]:
                results[r.rid] = r.out
