"""Plain PyTorch version of the fused CFG-guidance + ancestral-update step.

The numerical contract the Triton kernel must match (the JAX package's
``kernels/cfg_fuse/ref.py``):

    ε̂      = (1+s)·ε_c − s·ε_u                        (paper Eq. 8)
    x̂₀     = clip((x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t, ±1)
    σ_t    = η·√((1−ᾱ_prev)/(1−ᾱ_t)·(1−ᾱ_t/ᾱ_prev))
    x_{t-1} = √ᾱ_prev·x̂₀ + √(1−ᾱ_prev−σ²)·ε̂ + σ·z     (paper Eq. 9 / DDIM η)

``ab_t``/``ab_prev`` are scalars (numbers or 0-d tensors), taken as fp32
like the reference's traced scalars.
"""
from __future__ import annotations

import torch


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def ancestral_step(x, eps, ab_t, ab_prev, noise, eta: float = 1.0):
    ab_t, ab_prev = _f32(ab_t, x), _f32(ab_prev, x)
    x0 = (x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
    x0 = torch.clamp(x0, -1.0, 1.0)
    var = (1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev)
    sigma = eta * torch.sqrt(torch.clamp(var, min=0.0))
    dir_coef = torch.sqrt(torch.clamp(1.0 - ab_prev - sigma ** 2, min=0.0))
    return torch.sqrt(ab_prev) * x0 + dir_coef * eps + sigma * noise


def cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, noise, eta: float = 1.0):
    eps = (1.0 + s) * eps_c - s * eps_u
    return ancestral_step(x, eps, ab_t, ab_prev, noise, eta)
