"""Mamba-1 (S6) selective state-space block: the JAX package's
``models/ssm.py``.

The reference computes the selective scan chunk by chunk: an outer
``lax.scan`` over chunks of ``L = min(chunk, S)`` positions carries the
(B, d_inner, N) state, and a ``lax.associative_scan`` runs the first-order
recurrence h_t = a_t·h_{t-1} + b_t inside a chunk.  It is not a Pallas
kernel, and the port's plain version keeps the chunks but runs the
recurrence position by position inside each (one ``addcmul`` a position),
which differs from the associative scan only in the order of fp32
roundings.  The reference forms the scan inputs a and b for the whole
sequence at once; here they are formed one chunk at a time (elementwise the
same values), so the (B, L, d_inner, N) chunk tensors are the only large
intermediates.

Dtypes follow the reference: the projections, the conv weights and the
dt bias are cast to the activation dtype at use; ``A_log`` and ``D`` are
fp32 parameters used uncast; softplus, a, b, the scan and y are fp32, and
y is cast to the activation dtype before the ``silu(z)`` gate.

Decode keeps an O(1) recurrent state (``MambaState``: the SSM state and the
trailing conv window of pre-conv inputs).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models.layers import Dense


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, d_inner, N) SSM state, fp32
    conv: torch.Tensor    # (B, d_conv-1, d_inner) trailing conv window


def _dims(cfg: ModelConfig):
    mc = cfg.mamba or MambaConfig()
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_inner, dt_rank


class Mamba(nn.Module):
    """The reference's ``init_mamba`` leaves as parameters: the projections
    as ``Dense`` (``dt_proj`` with its bias), ``conv_w`` (d_conv, d_inner)
    and ``conv_b`` in the reference's layout, all in ``dtype``; ``A_log``
    (d_inner, N) and ``D`` (d_inner,) in fp32.  Allocated, not drawn."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        mc, din, dtr = _dims(cfg)
        d, N = cfg.d_model, mc.d_state
        kw = dict(device=device, dtype=dtype)
        self.in_proj = Dense(d, 2 * din, **kw)
        self.conv_w = nn.Parameter(torch.empty((mc.d_conv, din), **kw))
        self.conv_b = nn.Parameter(torch.zeros((din,), **kw))
        self.x_proj = Dense(din, dtr + 2 * N, **kw)
        self.dt_proj = Dense(dtr, din, bias=True, **kw)
        self.A_log = nn.Parameter(torch.empty((din, N), device=device))
        self.D = nn.Parameter(torch.empty((din,), device=device))
        self.out_proj = Dense(din, d, **kw)


def conv1d_causal(x, w, b):
    """Depthwise causal conv.  x: (B,S,din); w: (K,din).  The K taps are
    summed in x's dtype in tap order, as the reference's ``sum``."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b.to(x.dtype)


def conv1d_step(win, w, b):
    """The conv at one position from its window win: (B,K,din) -> (B,din),
    a contraction over the taps, as the reference's decode computes it."""
    return torch.einsum("bkd,kd->bd", win, w.to(win.dtype)) + b.to(win.dtype)


def _ssm_inputs(mod: Mamba, xc, dt_rank: int, N: int):
    """xc: (B,S,din) post-conv activations -> (dt (B,S,din) fp32 after
    softplus, B (B,S,N), C (B,S,N) in xc's dtype)."""
    dbc = mod.x_proj(xc)
    dt, Bm, Cm = dbc.split([dt_rank, N, N], dim=-1)
    dt = (F.linear(dt, mod.dt_proj.weight.to(xc.dtype))
          + mod.dt_proj.bias.to(xc.dtype))
    return F.softplus(dt.float()), Bm, Cm


def mamba_forward(mod: Mamba, cfg: ModelConfig, x, *, chunk: int = 128,
                  return_state: bool = False):
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d) [, final MambaState]."""
    mc, din, dtr = _dims(cfg)
    N = mc.d_state
    B, S, _ = x.shape
    xr, z = mod.in_proj(x).chunk(2, dim=-1)
    xc = F.silu(conv1d_causal(xr, mod.conv_w, mod.conv_b))
    dt, Bm, Cm = _ssm_inputs(mod, xc, dtr, N)
    A = -torch.exp(mod.A_log)                                   # (din,N)
    xcf = xc.float()
    dtx, Bf, Cf = dt * xcf, Bm.float(), Cm.float()

    L = min(chunk, S)
    assert S % L == 0, f"seq {S} not divisible by chunk {L}"
    h = torch.zeros((B, din, N), device=x.device)
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        a = torch.exp(dt[:, sl, :, None] * A)                   # (B,L,din,N)
        b = dtx[:, sl, :, None] * Bf[:, sl, None, :]
        hs = []
        for t in range(L):
            h = torch.addcmul(b[:, t], a[:, t], h)              # a·h + b
            hs.append(h)
        ys.append(torch.einsum("bldn,bln->bld", torch.stack(hs, 1),
                               Cf[:, sl]))
    y = torch.cat(ys, 1) + mod.D * xcf
    out = mod.out_proj(y.to(x.dtype) * F.silu(z))
    if return_state:
        return out, MambaState(h, xr[:, -(mc.d_conv - 1):, :])
    return out


def mamba_decode(mod: Mamba, cfg: ModelConfig, x, state: MambaState):
    """Single-token step.  x: (B,1,d) -> (out (B,1,d), new state)."""
    mc, din, dtr = _dims(cfg)
    N = mc.d_state
    xr, z = mod.in_proj(x).chunk(2, dim=-1)                     # (B,1,din)
    win = torch.cat([state.conv, xr], dim=1)                    # (B,K,din)
    xc = F.silu(conv1d_step(win, mod.conv_w, mod.conv_b))[:, None, :]
    dt, Bm, Cm = _ssm_inputs(mod, xc, dtr, N)                   # (B,1,...)
    A = -torch.exp(mod.A_log)
    a = torch.exp(dt[:, 0, :, None] * A)                        # (B,din,N)
    b = (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0].float()[:, None]
    h = a * state.h + b
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y + mod.D * xc[:, 0].float()
    out = mod.out_proj(y.to(x.dtype)[:, None, :] * F.silu(z))
    return out, MambaState(h, win[:, 1:])


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> MambaState:
    mc, din, _ = _dims(cfg)
    return MambaState(
        torch.zeros((batch, din, mc.d_state), device=device),
        torch.zeros((batch, mc.d_conv - 1, din), dtype=dtype, device=device))


def dt_bias(u: torch.Tensor) -> torch.Tensor:
    """The reference's dt bias from a uniform draw u: the inverse softplus
    of dt = exp(u·(log 0.1 − log 1e-3) + log 1e-3), dt log-uniform on
    [1e-3, 1e-1], in fp32 (the constants rounded to fp32 as jax's weak
    types round them)."""
    span = float(np.float32(math.log(0.1) - math.log(1e-3)))
    lo = float(np.float32(math.log(1e-3)))
    dt = torch.exp(u * span + lo)
    return dt + torch.log1p(-torch.exp(-dt))
