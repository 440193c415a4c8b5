"""Multi-head attention of the LM zoo: the JAX package's
``models/attention.py``.

Supports GQA/MQA (num_kv_heads <= num_heads), QKV bias (qwen2), qk-norm
(qwen3/olmoe), the attention-logit softcap and sliding-window masks
(gemma2), the bidirectional encoder mode, and KV-cache decode.

Full-sequence attention takes one of three routes: the flash-attention
kernel wrapper (``kernels/flash_attention``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors), the chunked online-softmax
loop, or the plain materialised softmax (``_attend``), the reference the
other two are held against.  Decode is always ``_attend`` over the whole
cache, as in the reference; on the card it reads a bf16 cache in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import Dense, RMSNorm, apply_rope
from repro_torch.models.moe import pin
from repro_torch.utils import softcap as _softcap

NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, head_dim)
    v: torch.Tensor  # (B, S_max, n_kv, head_dim)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(bias=cfg.qkv_bias, device=device, dtype=dtype)
        self.wq = Dense(d, cfg.num_heads * hd, **kw)
        self.wk = Dense(d, cfg.num_kv_heads * hd, **kw)
        self.wv = Dense(d, cfg.num_kv_heads * hd, **kw)
        self.wo = Dense(cfg.num_heads * hd, d, device=device, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, device)
        else:
            self.q_norm = self.k_norm = None


def _project_qkv(mod: Attention, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = mod.wq(x).reshape(B, S, cfg.num_heads, hd)
    k = mod.wk(x).reshape(B, S, cfg.num_kv_heads, hd)
    v = mod.wv(x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = mod.q_norm(q)
        k = mod.k_norm(k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_f32(qs, k):
    """q·kᵀ with fp32 output from bf16 operands, without an fp32 copy of k:
    qs (B, Sq, Hkv, rep, hd), k (B, Sk, Hkv, hd) → (B, Hkv, rep, Sq, Sk).
    One ``bmm(..., out_dtype=float32)`` per kv head reads that head of the
    cache in place (a strided, transposed operand) into its slice of one
    output; only q, a few rows, is copied."""
    B, Sq, Hkv, rep, hd = qs.shape
    qh = qs.permute(2, 0, 3, 1, 4).reshape(Hkv, B, rep * Sq, hd)
    out = torch.empty((Hkv, B, rep * Sq, k.shape[1]), dtype=torch.float32,
                      device=qs.device)
    for h in range(Hkv):
        torch.bmm(qh[h], k[:, :, h].transpose(1, 2), out_dtype=torch.float32,
                  out=out[h])
    return out.view(Hkv, B, rep, Sq, -1).transpose(0, 1)


def _mix_f32(p, v):
    """P·V with fp32 output from bf16 operands, without an fp32 copy of v:
    p (B, Hkv, rep, Sq, Sk), v (B, Sk, Hkv, hd) → (B, Sq, Hkv, rep, hd)."""
    B, Hkv, rep, Sq, Sk = p.shape
    out = torch.empty((Hkv, B, rep * Sq, v.shape[3]), dtype=torch.float32,
                      device=p.device)
    for h in range(Hkv):
        torch.bmm(p[:, h].reshape(B, rep * Sq, Sk), v[:, :, h],
                  out_dtype=torch.float32, out=out[h])
    return out.view(Hkv, B, rep, Sq, -1).permute(1, 3, 0, 2, 4)


def _attend(q, k, v, mask, cfg: ModelConfig, window: int):
    """Reference attention.  q: (B,Sq,Hq,hd); k,v: (B,Sk,Hkv,hd).

    ``mask``: (B, Sq, Sk) or (Sq, Sk) boolean, True = attend.

    q is scaled in its storage dtype, as in the reference; the contractions
    accumulate in fp32 (a bf16 product is exact in fp32), and the
    probabilities are cast to v's dtype before P·V.  On the card, bf16
    operands are contracted as they are stored, with fp32 output, as the
    reference's ``preferred_element_type=float32`` does: decode reads the
    whole cache every step, and an fp32 copy of it would cost more than the
    products.  On the CPU (no ``bmm`` with an fp32 output for bf16), and
    where a gradient flows (``bmm`` with an fp32 output has no derivative),
    the contractions run on fp32 copies, which give the same products.
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    qs = (q * scale).reshape(B, Sq, Hkv, rep, hd)
    in_place = (q.device.type == "cuda" and k.dtype != torch.float32
                and not (torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v))))
    if in_place:
        logits = _scores_f32(qs, k)
    else:
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qs.float(), k.float())
    if cfg.attn_softcap:
        logits = _softcap(logits, cfg.attn_softcap)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None, None], NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if in_place:
        out = _mix_f32(probs, v)
    else:
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, Hq * hd)


def _attend_chunked(q, k, v, cfg: ModelConfig, *, causal: bool, window: int,
                    blk: int = 1024):
    """Flash semantics in plain torch: a loop over KV blocks with
    online-softmax running stats.  Never materialises the (B,H,Sq,Sk)
    probability tensor; the per-block mask comes from position ranges."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    blk = min(blk, Sk)
    assert Sk % blk == 0, (Sk, blk)
    scale = hd ** -0.5
    qs = (q * scale).reshape(B, Sq, Hkv, rep, hd).float()
    qpos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, rep, Sq), NEG, device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, hd), device=q.device)
    for j in range(Sk // blk):
        kb = k[:, j * blk:(j + 1) * blk].float()
        vb = v[:, j * blk:(j + 1) * blk]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qs, kb)
        if cfg.attn_softcap:
            s = _softcap(s, cfg.attn_softcap)
        kpos = j * blk + torch.arange(blk, device=q.device)
        mask = torch.ones((Sq, blk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(v.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq * hd)
    return out.to(q.dtype)


def make_mask(Sq: int, Sk: int, *, causal: bool, window: int,
              q_offset: int = 0, device=None):
    """(Sq, Sk) boolean attention mask.  q position i maps to absolute
    position ``i + q_offset``; keys are absolute positions 0..Sk-1."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attention(mod: Attention, cfg: ModelConfig, x, positions, *,
              kind: str = "attn", use_kernels: bool = True,
              impl: str = "naive", par=None):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v)),
    k and v as projected (the cache keeps ``num_kv_heads``).  With
    ``par.gqa_repeat`` k and v are repeated to ``num_heads`` before any
    route (each kv head for its group of q heads, the same scores);
    ``par.qkv_spec`` is pinned on q, k and v (``moe.pin``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(mod, cfg, x, positions)
    kv = (k, v)
    if par is not None and par.gqa_repeat:
        rep = cfg.num_heads // cfg.num_kv_heads
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
    if par is not None and par.qkv_spec is not None:
        q_sh, kv_sh = par.qkv_spec
        q = pin(q, q_sh)
        k = pin(k, q_sh if par.gqa_repeat else kv_sh)
        v = pin(v, q_sh if par.gqa_repeat else kv_sh)
    window = cfg.sliding_window if kind == "attn_local" else 0
    causal = not cfg.is_encoder
    if use_kernels:
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cfg.attn_softcap)
        out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    elif impl == "chunked":
        out = _attend_chunked(q, k, v, cfg, causal=causal, window=window)
    else:
        mask = make_mask(S, S, causal=causal, window=window, device=x.device)
        out = _attend(q, k, v, mask, cfg, window)
    return mod.wo(out), kv


def attention_decode(mod: Attention, cfg: ModelConfig, x, cache: KVCache,
                     pos: int, *, kind: str = "attn"):
    """Single-token decode.  x: (B, 1, d); pos: the position of the new
    token, the same for the whole batch (synchronous decode).  Returns
    (out, cache).

    The new token's k and v are written into ``cache`` in place (the
    reference returns an updated copy through ``dynamic_update_slice``);
    the returned cache is the same tensors."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(mod, cfg, x, positions)
    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    S_max = cache.k.shape[1]
    window = cfg.sliding_window if kind == "attn_local" else 0
    kpos = torch.arange(S_max, device=x.device)
    valid = kpos <= pos
    if window:
        valid &= kpos > pos - window
    mask = valid[None, None, :].expand(B, 1, S_max)
    out = _attend(q, cache.k, cache.v, mask, cfg, window)
    return mod.wo(out), cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
