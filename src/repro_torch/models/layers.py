"""Basic layers of the LM zoo: the JAX package's ``models/layers.py`` as
``nn.Module``s.

Arithmetic follows the reference step for step: norms take their
statistics in fp32 and scale by ``(1 + scale)``; dense layers cast their
weight to the input's dtype (``nn.Linear`` weights are (out, in), the
reference's (in, out)); rope rotates split halves with fp32 angles; the
MLP's gelu is the tanh form (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm.ref import rmsnorm

# ---------------------------------------------------------------------------
# Initialisers of the LM
# ---------------------------------------------------------------------------
# The LM's layers draw their initial weights from a ``torch.Generator``:
# the reference's key-drawn ``init_lm`` is not ported yet, so these values
# are the port's own.  Parameters that must equal the reference's load
# through ``repro_torch.convert``.  The DiT and the classifiers draw from
# threefry keys instead (``repro_torch.utils.lecun_init``/``normal_init``).


def seeded_normal_init(shape, generator: torch.Generator | None = None,
                       stddev: float = 0.02, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * stddev


def seeded_lecun_init(shape, generator: torch.Generator | None = None,
                      device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan_in = shape[0])."""
    w = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w / math.sqrt(max(shape[0], 1))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def layernorm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


class RMSNorm(nn.Module):
    """``(1 + scale)`` convention: the scale starts at zero, in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


class Dense(nn.Linear):
    """``x @ w (+ b)`` with the weight cast to x's dtype, as the
    reference's ``dense``.  LeCun-initialised on the (in, out) matrix, bias
    zero; held in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias, device=device, dtype=dtype)
        with torch.no_grad():
            self.weight.copy_(
                seeded_lecun_init((d_in, d_out), generator, device).T)
            if bias:
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, dim: int, generator=None, device=None,
                   dtype=torch.float32):
    return nn.Parameter(
        seeded_normal_init((vocab, dim), generator, 0.02, device).to(dtype))


def embed(table, ids, dtype):
    return F.embedding(ids, table.to(dtype))


def unembed(table, x):
    """Tied read-out: x @ E^T."""
    return x @ table.to(x.dtype).T


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)                # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs          # (...,S,1,hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool, act: str = "silu",
                 *, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_up = Dense(d_model, d_ff, **kw)
        self.w_down = Dense(d_ff, d_model, **kw)
        self.w_gate = Dense(d_model, d_ff, **kw) if gated else None
        self.act = act

    def _act(self, v):
        if self.act == "silu":
            return F.silu(v)
        return F.gelu(v, approximate="tanh")   # jax.nn.gelu's default form

    def forward(self, x):
        up = self.w_up(x)
        if self.w_gate is not None:
            up = self._act(self.w_gate(x)) * up
        else:
            up = self._act(up)
        return self.w_down(up)
