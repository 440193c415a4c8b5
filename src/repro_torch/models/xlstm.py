"""xLSTM blocks (arXiv:2405.04517): the JAX package's ``models/xlstm.py``.
mLSTM (matrix memory) and sLSTM (scalar memory), both with exponential
gating and max-stabilisers.

mLSTM runs in the reference's stabilised chunkwise-parallel form: within a
chunk quadratic products, across chunks the (C, n, m) state carried by a
loop over chunks (the reference's ``lax.scan``).  sLSTM has a true
hidden-state recurrence (its gates see h_{t-1}), so it runs as a loop over
time, as the reference's ``lax.scan`` does.  Neither is a Pallas kernel in
the reference; both are plain PyTorch here.

Dtypes follow the reference: projections and conv weights are cast to the
activation dtype at use; q, k, v, the gates and the states are fp32;
sLSTM's recurrent weights ``w_r`` and its bias ``b`` are fp32 parameters
used uncast, so a gate pre-activation (activation-dtype input term plus
fp32 recurrent term) is fp32.  Norm scales are fp32, ``(1 + scale)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.models.layers import Dense, RMSNorm
from repro_torch.models.ssm import conv1d_causal, conv1d_step

NEG = -1e30


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, H, hd, hd) matrix memory
    n: torch.Tensor     # (B, H, hd) normaliser
    m: torch.Tensor     # (B, H) stabiliser
    conv: torch.Tensor  # (B, K-1, din) conv window


class SLSTMState(NamedTuple):
    h: torch.Tensor     # (B, d)
    c: torch.Tensor     # (B, d)
    n: torch.Tensor     # (B, d)
    m: torch.Tensor     # (B, d)


def _xc(cfg: ModelConfig) -> XLSTMConfig:
    return cfg.xlstm or XLSTMConfig()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class mLSTM(nn.Module):
    """The reference's ``init_mlstm`` leaves as parameters in ``dtype``
    (``conv_w`` (K, din) in its layout), ``head_norm`` an fp32 RMSNorm
    over din.  Allocated, not drawn."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        xc = _xc(cfg)
        d, H = cfg.d_model, cfg.num_heads
        din = int(xc.proj_factor * d)
        kw = dict(device=device, dtype=dtype)
        self.in_proj = Dense(d, 2 * din, **kw)
        self.conv_w = nn.Parameter(torch.empty((xc.conv_kernel, din), **kw))
        self.conv_b = nn.Parameter(torch.zeros((din,), **kw))
        self.wq = Dense(din, din, **kw)
        self.wk = Dense(din, din, **kw)
        self.wv = Dense(din, din, **kw)
        self.w_igate = Dense(din, H, bias=True, **kw)
        self.w_fgate = Dense(din, H, bias=True, **kw)
        self.head_norm = RMSNorm(din, cfg.norm_eps, device)
        self.out_proj = Dense(din, d, **kw)


def _gate(dense: Dense, x):
    """``x @ w + b``, each cast to x's dtype: two roundings, as the
    reference's."""
    return F.linear(x, dense.weight.to(x.dtype)) + dense.bias.to(x.dtype)


def _mlstm_chunk(q, k, v, ig, lf, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q,k,v: (B,H,L,hd) (k pre-scaled by hd^-0.5); ig/lf: (B,H,L) input-gate
    logits and log-sigmoid forget logits; state: (C0 (B,H,hd,hd), n0, m0).
    Returns (h (B,H,L,hd), new state tuple)."""
    C0, n0, m0 = state
    L = q.shape[2]
    lfc = torch.cumsum(lf, dim=-1)                               # (B,H,L)
    # intra-chunk log weights a[t,s] = lfc_t - lfc_s + ig_s, s <= t
    A = lfc[..., :, None] - lfc[..., None, :] + ig[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    A = torch.where(tri, A, torch.full((), NEG, device=q.device))
    b = lfc + m0[..., None]                                      # inter
    m_t = torch.maximum(A.amax(-1), b)                           # (B,H,L)
    D = torch.exp(A - m_t[..., None])                            # (B,H,L,L)
    ib = torch.exp(b - m_t)                                      # (B,H,L)
    S_qk = q @ k.transpose(-1, -2)
    num = (S_qk * D) @ v
    num = num + ib[..., None] * (q @ C0)
    n_t = D @ k + ib[..., None] * n0[..., None, :]
    denom = torch.maximum((n_t * q).sum(-1).abs(), torch.exp(-m_t))
    h = num / denom[..., None]
    # ---- chunk-end state ----
    lf_end = lfc[..., -1]
    w_log = lf_end[..., None] - lfc + ig                         # (B,H,L)
    m_new = torch.maximum(lf_end + m0, w_log.amax(-1))
    w = torch.exp(w_log - m_new[..., None])
    carry = torch.exp(lf_end + m0 - m_new)
    C_new = carry[..., None, None] * C0 + (w[..., None] * k).transpose(
        -1, -2) @ v
    n_new = carry[..., None] * n0 + (w[..., None] * k).sum(-2)
    return h, (C_new, n_new, m_new)


def _qkv_gates(mod: mLSTM, xm, xconv, H: int):
    """q, k (scaled by hd^-0.5), v as (..., H, hd) and the input-gate and
    log-sigmoid forget-gate logits (..., H), all fp32."""
    hd = xm.shape[-1] // H

    def heads(t):
        return t.reshape(*t.shape[:-1], H, hd).float()

    q = heads(mod.wq(xconv))
    k = heads(mod.wk(xconv)) * (hd ** -0.5)
    v = heads(mod.wv(xm))
    ig = _gate(mod.w_igate, xm).float()
    lf = F.logsigmoid(_gate(mod.w_fgate, xm).float())
    return q, k, v, ig, lf


def mlstm_forward(mod: mLSTM, cfg: ModelConfig, x, *, chunk: int = 256,
                  return_state: bool = False):
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d) [, MLSTMState]."""
    xc = _xc(cfg)
    H = cfg.num_heads
    B, S, _ = x.shape
    xm, z = mod.in_proj(x).chunk(2, dim=-1)
    din = xm.shape[-1]
    hd = din // H
    xconv = F.silu(conv1d_causal(xm, mod.conv_w, mod.conv_b))
    q, k, v, ig, lf = _qkv_gates(mod, xm, xconv, H)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))            # (B,H,S,hd)
    ig, lf = ig.transpose(1, 2), lf.transpose(1, 2)              # (B,H,S)

    L = min(chunk, S)
    assert S % L == 0, f"seq {S} not divisible by chunk {L}"
    state = (torch.zeros((B, H, hd, hd), device=x.device),
             torch.zeros((B, H, hd), device=x.device),
             torch.full((B, H), NEG, device=x.device))
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                ig[..., sl], lf[..., sl], state)
        hs.append(h)
    h = torch.cat(hs, 2).transpose(1, 2).reshape(B, S, din).to(x.dtype)
    h = mod.head_norm(h)
    out = mod.out_proj(h * F.silu(z))
    if return_state:
        return out, MLSTMState(*state, xm[:, -(xc.conv_kernel - 1):, :])
    return out


def mlstm_decode(mod: mLSTM, cfg: ModelConfig, x, state: MLSTMState):
    """x: (B,1,d) single-token step -> (out (B,1,d), new state)."""
    H = cfg.num_heads
    B = x.shape[0]
    xm, z = mod.in_proj(x).chunk(2, dim=-1)
    din = xm.shape[-1]
    win = torch.cat([state.conv, xm], dim=1)                     # (B,K,din)
    xconv = F.silu(conv1d_step(win, mod.conv_w, mod.conv_b))
    q, k, v, ig, lf = _qkv_gates(mod, xm[:, 0], xconv, H)
    m_new = torch.maximum(lf + state.m, ig)
    fs = torch.exp(lf + state.m - m_new)
    is_ = torch.exp(ig - m_new)
    C = (fs[..., None, None] * state.C
         + is_[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = fs[..., None] * state.n + is_[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    denom = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))
    h = (num / denom[..., None]).reshape(B, din).to(x.dtype)
    h = mod.head_norm(h)
    out = mod.out_proj(h[:, None, :] * F.silu(z))
    return out, MLSTMState(C, n, m_new, win[:, 1:])


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> MLSTMState:
    xc = _xc(cfg)
    H = cfg.num_heads
    din = int(xc.proj_factor * cfg.d_model)
    hd = din // H
    return MLSTMState(
        torch.zeros((batch, H, hd, hd), device=device),
        torch.zeros((batch, H, hd), device=device),
        torch.full((batch, H), NEG, device=device),
        torch.zeros((batch, xc.conv_kernel - 1, din), dtype=dtype,
                    device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class sLSTM(nn.Module):
    """The reference's ``init_slstm`` leaves as parameters: ``w_x``,
    ``up_proj`` and ``down_proj`` in ``dtype``; ``w_r`` (H, hd, 4·hd) and
    ``b`` (4d) in fp32; ``head_norm`` an fp32 RMSNorm over d.  Allocated,
    not drawn."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        xc = _xc(cfg)
        d, H = cfg.d_model, cfg.num_heads
        hd = d // H
        dff = int(xc.slstm_proj_factor * d)
        kw = dict(device=device, dtype=dtype)
        self.w_x = Dense(d, 4 * d, **kw)
        self.w_r = nn.Parameter(torch.empty((H, hd, 4 * hd), device=device))
        self.b = nn.Parameter(torch.empty((4 * d,), device=device))
        self.head_norm = RMSNorm(d, cfg.norm_eps, device)
        self.up_proj = Dense(d, 2 * dff, **kw)
        self.down_proj = Dense(dff, d, **kw)


def _slstm_cell(mod: sLSTM, xg, state: SLSTMState) -> SLSTMState:
    """One time step.  xg: (B, 4d) pre-computed input contribution."""
    H, hd = mod.w_r.shape[:2]
    B = xg.shape[0]
    rec = torch.einsum("bhd,hde->bhe", state.h.reshape(B, H, hd),
                       mod.w_r).reshape(B, -1)
    g = (xg + rec + mod.b).float()
    zt, it, ft, ot = g.chunk(4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + state.m, it)
    fs = torch.exp(lf + state.m - m_new)
    is_ = torch.exp(it - m_new)
    c = fs * state.c + is_ * z
    n = fs * state.n + is_
    h = o * c / torch.clamp(n, min=1e-6)
    return SLSTMState(h, c, n, m_new)


def _slstm_out(mod: sLSTM, h):
    """The block's head norm and gated (tanh-gelu) up/down projection."""
    h = mod.head_norm(h)
    up, gate = mod.up_proj(h).chunk(2, dim=-1)
    return mod.down_proj(up * F.gelu(gate, approximate="tanh"))


def slstm_forward(mod: sLSTM, cfg: ModelConfig, x, *,
                  return_state: bool = False):
    """Full-sequence forward, a loop over time.  x: (B,S,d) -> (B,S,d)
    [, SLSTMState]."""
    B, S, _ = x.shape
    xg = mod.w_x(x)                                              # (B,S,4d)
    state = init_slstm_state(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(mod, xg[:, t], state)
        hs.append(state.h)
    out = _slstm_out(mod, torch.stack(hs, 1).to(x.dtype))
    if return_state:
        return out, state
    return out


def slstm_decode(mod: sLSTM, cfg: ModelConfig, x, state: SLSTMState):
    """x: (B,1,d) single-token step -> (out (B,1,d), new state)."""
    new = _slstm_cell(mod, mod.w_x(x[:, 0]), state)
    return _slstm_out(mod, new.h.to(x.dtype)[:, None, :]), new


def init_slstm_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> SLSTMState:
    d = cfg.d_model
    z = torch.zeros((batch, d), device=device)
    return SLSTMState(z, z, z, torch.full((batch, d), NEG, device=device))
