"""Plain PyTorch version of the fused RMSNorm: the JAX package's
``kernels/rmsnorm/ref.py``, ``x·rsqrt(mean(x²)+eps)·(1+scale)`` with fp32
statistics, cast back to x's dtype (the ``(1+scale)`` convention of
``models/layers.rmsnorm``)."""
from __future__ import annotations

import torch


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
