"""Plain PyTorch version of the fused CFG-guidance + ancestral-update step.

The numerical contract the kernels must match (the JAX package's
``kernels/cfg_fuse/ref.py``):

    ε̂      = (1+s)·ε_c − s·ε_u                        (paper Eq. 8)
    x̂₀     = clip((x_t − √(1−ᾱ_t)·ε̂)/√ᾱ_t, ±1)
    σ_t    = η·√((1−ᾱ_prev)/(1−ᾱ_t)·(1−ᾱ_t/ᾱ_prev))
    x_{t-1} = √ᾱ_prev·x̂₀ + √(1−ᾱ_prev−σ²)·ε̂ + σ·z     (paper Eq. 9 / DDIM η)

``ab_t``/``ab_prev`` are scalars (numbers or 0-d tensors), taken as fp32
like the reference's traced scalars; the rowwise forms take one per row.

The keyed forms are the kernels' draw-in-registers mode: z is
``prng.normal`` of the given threefry keys, as the samplers draw it, then
the same update.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng


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


def cfg_update_keyed(x, eps_c, eps_u, s, ab_t, ab_prev, key, live: bool,
                     eta: float = 1.0):
    """``cfg_update`` with z = ``prng.normal(key, x.shape)`` on x's device,
    or zeros where the step is not ``live`` (t = 0)."""
    z = (prng.normal(np.asarray(key, np.uint32), x.shape, x.device) if live
         else torch.zeros_like(x))
    return cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, z, eta)


def row_noise(keys, live, shape, device) -> torch.Tensor:
    """Each row's noise: ``prng.normal(keys[b], shape)`` times ``live[b]``.
    ``keys`` is a (B, 2) int32 tensor of the uint32 key words or a uint32
    array; ``live`` (B,) holds 1 and 0."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy().view(np.uint32)
    z = prng.normal(np.asarray(keys, np.uint32), shape, device)
    live = torch.as_tensor(live, dtype=torch.float32, device=device)
    return z * live.reshape((-1,) + (1,) * len(shape))


def cfg_update_rowwise(x, eps_c, eps_u, s, ab_t, ab_prev, noise, active,
                       eta: float = 1.0):
    """Per-row (ragged-wave) variant: ``s``, ``ab_t``, ``ab_prev`` and
    ``active`` are (B,) vectors, one (guidance, schedule position) per batch
    row.  A row whose ``active`` is not > 0 (its right-aligned trajectory
    has not started) passes through bit-unchanged."""
    def r(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device) \
            .reshape((-1,) + (1,) * (x.ndim - 1))

    s, ab_t, ab_prev = r(s), r(ab_t), r(ab_prev)
    out = cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, noise, eta)
    return torch.where(r(active) > 0, out, x)


def cfg_update_rowwise_windowed(x, eps_c, eps_u, s, ab_t, ab_prev, noise,
                                active, row_offset: int = 0,
                                eta: float = 1.0):
    """The window form: the per-row vectors span a whole wave and ``x``
    holds the rows from ``row_offset`` on, so tensor row b reads slot
    ``row_offset + b``."""
    w = slice(row_offset, row_offset + x.shape[0])
    return cfg_update_rowwise(x, eps_c, eps_u, *(
        torch.as_tensor(v)[w] for v in (s, ab_t, ab_prev)), noise,
        torch.as_tensor(active)[w], eta)


def cfg_update_mixed(x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise, active,
                     eta: float = 1.0):
    """Per-row mixed-guidance variant: ``mode`` (B,) picks each row's
    combine.  A row with mode < 0.5 takes (1+s)·ε_c − s·ε_u (classifier-free,
    and unconditional as its s = 0 point on a null condition); any other row
    takes ``eps_c`` as its already corrected ε̂ (classifier guidance forms
    it upstream).  Every other line is ``cfg_update_rowwise``'s arithmetic,
    so an all-mode-0 call equals it bit for bit."""
    def r(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device) \
            .reshape((-1,) + (1,) * (x.ndim - 1))

    mode, s, ab_t, ab_prev = r(mode), r(s), r(ab_t), r(ab_prev)
    eps = torch.where(mode < 0.5, (1.0 + s) * eps_c - s * eps_u, eps_c)
    out = ancestral_step(x, eps, ab_t, ab_prev, noise, eta)
    return torch.where(r(active) > 0, out, x)


def cfg_update_mixed_windowed(x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise,
                              active, row_offset: int = 0, eta: float = 1.0):
    """The window form of ``cfg_update_mixed``: the per-row vectors, ``mode``
    included, span a whole wave and tensor row b reads slot
    ``row_offset + b``."""
    w = slice(row_offset, row_offset + x.shape[0])
    return cfg_update_mixed(x, eps_c, eps_u, *(
        torch.as_tensor(v)[w] for v in (mode, s, ab_t, ab_prev)), noise,
        torch.as_tensor(active)[w], eta)
