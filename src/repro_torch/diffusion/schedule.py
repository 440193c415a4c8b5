"""Noise schedules for DDPM (Ho et al. 2020) — Eq. 1 of the paper."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils import resolve_device


class NoiseSchedule(NamedTuple):
    betas: torch.Tensor           # (T,)
    alphas: torch.Tensor          # (T,)
    alpha_bar: torch.Tensor       # (T,) cumulative products
    sqrt_ab: torch.Tensor         # sqrt(alpha_bar)
    sqrt_1mab: torch.Tensor       # sqrt(1 - alpha_bar)

    @property
    def T(self) -> int:
        return self.betas.shape[0]


def make_schedule(T: int = 1000, kind: str = "cosine",
                  beta_start: float = 1e-4, beta_end: float = 0.02,
                  device=None) -> NoiseSchedule:
    """fp32 schedule, computed on the CPU and moved to ``device`` (the card
    unless the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    f32 = torch.float32
    if kind == "linear":
        betas = torch.linspace(beta_start, beta_end, T, dtype=f32)
    elif kind == "cosine":  # Nichol & Dhariwal
        s = 0.008
        t = torch.arange(T + 1, dtype=f32) / T
        f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
        alpha_bar = f / f[0]
        betas = torch.clamp(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
    else:
        raise ValueError(kind)
    alphas = 1.0 - betas
    alpha_bar = torch.cumprod(alphas, 0)
    sched = NoiseSchedule(betas, alphas, alpha_bar, torch.sqrt(alpha_bar),
                          torch.sqrt(1.0 - alpha_bar))
    return NoiseSchedule(*(a.to(device) for a in sched))


def q_sample(sched: NoiseSchedule, x0, t, noise):
    """Forward process (Eq. 1 marginal): x_t = √ᾱ_t x_0 + √(1-ᾱ_t) ε."""
    a = sched.sqrt_ab[t][..., None, None, None]
    b = sched.sqrt_1mab[t][..., None, None, None]
    return a * x0 + b * noise
