"""Latent attention (MLA) of the DeepSeek-V3 block, as Moonlight-16B-A3B
runs it; the JAX package has none.

Per token, q is projected straight from the residual (``q_lora_rank``
null) to H heads of q·k's head dim, ``qk_nope_head_dim`` + ``qk_rope_head_dim``
(128 + 64); ``wkv_a`` gives one latent of ``kv_lora_rank`` (512), RMS-normed
(``kv_norm``), and one rope key of 64 that every head shares; ``wkv_b``
expands the normed latent into each head's k_nope (128) and v
(``v_head_dim``, 128).  Rope rotates q's and the shared key's last 64
dims, pairing elements (2i, 2i + 1) as DeepSeek-V3's code does (it
de-interleaves them, then rotates halves), at θ^(−2i/64).  The softmax
scale is (q·k's head dim)^−½.

Two paths, as DeepSeek-V3's inference runs them:

* **prefill** (``mla_attention``): ``mla_latent`` (the down projection,
  the norm, the up projection, rope and the k assembly, a module-level
  function so that a benchmark region can wrap it) gives per-head k =
  [k_nope, k_rope] at 192 and v at 128, and the flash-attention wrapper
  takes them as they are (its tensor-core kernel's (192, 128) class on the
  card; V is not padded).  It returns the layer's ``LatentCache``: the
  normed latent and the roped key, in the activation dtype;
* **decode** (``mla_decode``): the absorbed form.  q_nope is folded
  through ``wkv_b``'s k half into the latent (H × 512 a token) and scored
  against the cached latents, q_rope against the cached rope keys; the
  probabilities weight the cached latents, and ``wkv_b``'s v half, then
  ``wo``, take the result out.  The cache is read in place (on the card
  bf16 operands with fp32 products, ``_bmm_f32``) and never expanded.

Under an enabled current tracer (``obs/trace.py``) each call is an ``mla``
span holding ``mla.latent`` and the ``flash_attention`` span in prefill, or
``mla.decode`` in decode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import Dense, RMSNorm, rope_freqs
from repro_torch.obs.trace import current


class LatentCache(NamedTuple):
    c_kv: torch.Tensor     # (B, S_max, kv_lora_rank), normed
    k_rope: torch.Tensor   # (B, S_max, qk_rope_head_dim), roped


class MLA(nn.Module):
    """The mixer's weights, allocated, not drawn: ``wq`` d → H·192,
    ``wkv_a`` d → 512 + 64, ``kv_norm`` over the 512, ``wkv_b`` 512 →
    H·(128 + 128) (each head's k_nope, then its v), ``wo`` H·128 → d."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d, H * m.qk_head_dim, **kw)
        self.wkv_a = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw)
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, device)
        self.wkv_b = Dense(m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim), **kw)
        self.wo = Dense(H * m.v_head_dim, d, **kw)


def rope_pairs(x, positions, theta: float):
    """DeepSeek-V3's rope: x (..., S, H, r) with elements (2i, 2i + 1)
    paired and rotated by position · θ^(−2i/r), returned de-interleaved
    (the rotated evens, then the rotated odds), fp32 arithmetic rounded
    once to x's dtype.  positions broadcast to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _queries(mod: MLA, cfg: ModelConfig, x, positions):
    """(q_nope (B, S, H, 128), q_rope (B, S, H, 64) roped) of x (B, S, d)."""
    m = cfg.mla
    B, S, _ = x.shape
    q = mod.wq(x).view(B, S, cfg.num_heads, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, rope_pairs(q_rope, positions, cfg.rope_theta)


def _latent(mod: MLA, cfg: ModelConfig, x, positions):
    """(c_kv (B, S, 512) normed, k_rope (B, S, 64) roped) of x (B, S, d)."""
    m = cfg.mla
    c, k_rope = mod.wkv_a(x).split([m.kv_lora_rank, m.qk_rope_head_dim],
                                   -1)
    k_rope = rope_pairs(k_rope[:, :, None], positions, cfg.rope_theta)
    return mod.kv_norm(c), k_rope[:, :, 0]


def mla_latent(mod: MLA, cfg: ModelConfig, x, positions):
    """The prefill's latent path of x (B, S, d): q (B, S, H, 192), k (B, S,
    H, 192) = [k_nope, k_rope], v (B, S, H, 128) (a view into the up
    projection's output) and the ``LatentCache`` of the S positions."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _queries(mod, cfg, x, positions)
    c_kv, k_rope = _latent(mod, cfg, x, positions)
    kv = mod.wkv_b(c_kv).view(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, -1)], -1)
    return q, k, v, LatentCache(c_kv, k_rope)


def mla_attention(mod: MLA, cfg: ModelConfig, x, positions, *,
                  use_kernels: bool = True):
    """Causal latent attention of x (B, S, d) (train / prefill).  Returns
    (out (B, S, d), ``LatentCache``).  ``use_kernels`` off is the plain
    materialised softmax (``attention._attend``)."""
    B, S, _ = x.shape
    tr = current()
    with tr.span("mla"):
        with tr.span("mla.latent"):
            q, k, v, cache = mla_latent(mod, cfg, x, positions)
        if use_kernels:
            out = fa_ops.flash_attention(q, k, v, causal=True)
        else:
            mask = attn_mod.make_mask(S, S, causal=True, window=0,
                                      device=x.device)
            out = attn_mod._attend(q, k, v, mask, cfg, 0)
        return mod.wo(out.reshape(B, S, -1)), cache


def _bmm_f32(a, b):
    """a @ b with an fp32 result: on the card, bf16 operands as they are
    stored (``out_dtype``; the cache read in place); elsewhere on fp32
    copies, the same products."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mla_decode(mod: MLA, cfg: ModelConfig, x, cache: LatentCache,
               pos: int):
    """One decode step of x (B, 1, d) at position ``pos`` (the same for the
    whole wave).  The token's latent and rope key are written into
    ``cache`` in place; attention reads positions 0..pos of it in the
    absorbed form.  Returns (out (B, 1, d), cache)."""
    m, H = cfg.mla, cfg.num_heads
    B = x.shape[0]
    dt = cache.c_kv.dtype
    tr = current()
    with tr.span("mla"), tr.span("mla.decode"):
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        q_nope, q_rope = _queries(mod, cfg, x, positions)
        c_new, r_new = _latent(mod, cfg, x, positions)
        cache.c_kv[:, pos] = c_new[:, 0].to(dt)
        cache.k_rope[:, pos] = r_new[:, 0].to(dt)
        c_kv, k_rope = cache.c_kv[:, :pos + 1], cache.k_rope[:, :pos + 1]
        w = mod.wkv_b.weight.to(dt).view(
            H, m.qk_nope_head_dim + m.v_head_dim, m.kv_lora_rank)
        w_k, w_v = w.split([m.qk_nope_head_dim, m.v_head_dim], 1)
        # q_nope folded into the latent: (H, B, 128) @ (H, 128, 512)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1).to(dt), w_k)
        scores = (_bmm_f32(q_lat.transpose(0, 1), c_kv.transpose(1, 2))
                  + _bmm_f32(q_rope[:, 0].to(dt), k_rope.transpose(1, 2)))
        probs = torch.softmax(scores * m.qk_head_dim ** -0.5, -1).to(dt)
        o_lat = _bmm_f32(probs, c_kv).to(dt)             # (B, H, 512)
        # out of the latent through wkv_b's v half: (H, B, 512) @ (H, 512, 128)
        o = torch.bmm(o_lat.transpose(0, 1), w_v.transpose(1, 2))
        out = mod.wo(o.transpose(0, 1).reshape(B, 1, H * m.v_head_dim))
    return out, cache


def init_latent_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None) -> LatentCache:
    m = cfg.mla
    return LatentCache(
        torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                    device=device))
