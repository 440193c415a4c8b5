"""Basic layers of the LM zoo: the JAX package's ``models/layers.py`` as
``nn.Module``s.

Arithmetic follows the reference step for step: norms take their
statistics in fp32 and scale by ``(1 + scale)``; dense layers cast their
weight to the input's dtype (``nn.Linear`` weights are (out, in), the
reference's (in, out)); rope rotates split halves with fp32 angles; the
MLP's gelu is the tanh form (``jax.nn.gelu``'s default).

The layers allocate their weights and draw nothing: ``models/transformer.py
::init_lm`` draws the reference's initial weights from a threefry key, and
``convert.lm_state_from_jax`` loads a reference tree.  Norm scales and
biases start at zero, as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm.ref import rmsnorm

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
    reference's ``dense``; held in ``dtype``.  The weight is allocated, not
    drawn; the bias is zero."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias, device=device, dtype=dtype)

    def reset_parameters(self):
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, dim: int, device=None, dtype=torch.float32):
    """The (vocab, dim) table, allocated, not drawn."""
    return nn.Parameter(torch.empty((vocab, dim), device=device, dtype=dtype))


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
                 *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
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
