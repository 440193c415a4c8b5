"""Plain PyTorch attention: materialised softmax with every mode of the
JAX package's ``kernels/flash_attention/ref.py`` (causal mask, sliding
window, logit softcap, GQA).

Layout contract: q, k, v are (B, H, S, hd); GQA is H_q = rep · H_kv with
k/v unrepeated — the function repeats them itself."""
from __future__ import annotations

import torch


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0):
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
