"""Serving steps: prefill (batch context ingest) and decode (one token
against the KV cache), as the JAX package's ``serve/steps.py`` makes them.
The model carries its own parameters, so the steps close over it."""
from __future__ import annotations

import torch

from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM


def make_prefill_step(lm: LM, par: Parallel = Parallel()):
    """prefill_step(tokens) -> (last_logits (B,1,V), caches)."""

    @torch.inference_mode()
    def prefill_step(tokens):
        logits, _, caches = lm(tokens, par, mode="prefill")
        return logits[:, -1:, :], caches

    return prefill_step


def make_serve_step(lm: LM, par: Parallel = Parallel()):
    """serve_step(tokens (B,1), caches, pos) -> (next_token (B,1), logits,
    caches).  Greedy: the argmax runs over the padded vocab, as in the
    reference."""

    @torch.inference_mode()
    def serve_step(tokens, caches, pos):
        logits, caches = lm.decode_step(tokens, caches, pos, par)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, caches

    return serve_step
