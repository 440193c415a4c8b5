"""Plain PyTorch version of the fused adaLN LayerNorm.

Matches the DiT modulation sites: a mean-subtracting LayerNorm over d (no
learned gain or bias, fp32 statistics, eps 1e-6) followed by the adaLN-zero
modulation ``(1 + scale)·x̂ + shift`` with a per-batch-row (d,) scale and
shift (the JAX package's ``kernels/adaln_norm/ref.py``)."""
from __future__ import annotations

import torch


def adaln_norm(x, scale, shift, eps: float = 1e-6):
    """x: (B, N, d) tokens; scale/shift: (B, d) per-row modulation."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float())[:, None] + shift.float()[:, None]
    return y.to(x.dtype)
