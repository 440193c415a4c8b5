"""Classifier-free guidance and the reverse-process core.

``reverse_sample`` owns the respacing, the step loop, the per-step noise
draw and the fused guidance-combine + ancestral update (the ``cfg_fuse``
kernel on CUDA).  A strategy produces the score pair per step; this slice
ports the classifier-free one.

Randomness comes from an explicit ``torch.Generator`` (x_T first, then one
draw per step).  Tests that hold the port against the JAX package inject
the reference's threefry draws through ``x_T`` and ``noise`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.kernels.cfg_fuse import ops as cfg_ops

# The reference's sampler traces its float32 linspace inside a jit, where
# XLA's CPU backend fuses it with the rounding into one loop computing
# (T-1) * (1 - i * fl(1/div)).  From this many elements on that loop
# fuses ``1 - i * c`` into one rounding (FMA); below it, it rounds twice.
_XLA_FMA_MIN = 17


def _reference_linspace(start: int, num: int) -> np.ndarray:
    """``jnp.linspace(start, 0, num)`` in float32 as the reference's
    ``sample_cfg`` evaluates it.  Only its rounding at exact half-integers
    changes the rounded trajectory, and that depends on whether
    ``1 - i/div`` was rounded once or twice."""
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    c = np.float32(1) / np.float32(div)
    i = np.arange(div)
    if num >= _XLA_FMA_MIN:     # exact in float64, then one rounding
        frac = (1.0 - i * np.float64(c)).astype(np.float32)
    else:
        frac = np.float32(1) - i.astype(np.float32) * c
    out = (np.float64(np.float32(start)) * frac).astype(np.float32)
    return np.concatenate([out, np.zeros(1, np.float32)])


def _strictly_decreasing(ts: np.ndarray) -> np.ndarray:
    """The tightest strictly decreasing integer envelope under ``ts`` that
    still ends at 0 (``cummin(ts + i) - i``, floored at ``num - 1 - i``):
    the identity on any already strictly decreasing trajectory."""
    n = len(ts)
    i = np.arange(n)
    ts = np.minimum.accumulate(ts + i) - i
    return np.maximum(ts, n - 1 - i)


def respaced_ts(T: int, num_steps: int) -> torch.Tensor:
    """The respaced integer trajectory (num_steps,) from T-1 down to 0: the
    timesteps the reference's ``sample_cfg`` visits, for every
    ``num_steps <= T``.  On the CPU.

    The reference's ``respaced_ts`` called eagerly (as its ragged engine,
    not ported yet, calls it) returns another trajectory at some step
    counts, e.g. 19 and 27 at T = 1000; the port follows the sampler."""
    if num_steps > T:
        raise ValueError(
            f"num_steps={num_steps} > T={T}: a respaced trajectory cannot "
            f"visit more distinct timesteps than the schedule has")
    ts = np.round(_reference_linspace(T - 1, num_steps)).astype(np.int64)
    return torch.from_numpy(_strictly_decreasing(ts))


def ancestral_coeffs(sched: NoiseSchedule, ts: torch.Tensor):
    """Per-step (ᾱ_t, ᾱ_prev) for the respaced trajectory."""
    ab = sched.alpha_bar
    ts = ts.to(ab.device)
    ab_t = ab[ts]
    ab_prev = torch.cat([ab[ts[1:]], torch.ones(1, device=ab.device)])
    return ab_t, ab_prev


@dataclass(frozen=True)
class ClassifierFree:
    """Paper Eq. 8: ε̂ = (1+s)·ε_θ(x,t,ȳ) − s·ε_θ(x,t,Ø), both score
    evaluations in ONE denoiser call (cond and uncond stacked on batch)."""
    y: torch.Tensor             # (B, cond_dim) encodings ȳ
    scale: float

    def batch(self) -> int:
        return self.y.shape[0]

    def prepare(self, model: DiT):
        B = self.y.shape[0]
        null = model.null_y.expand(B, model.dc.cond_dim)
        return torch.cat([self.y.float(), null], dim=0)

    def eps(self, model: DiT, x, t: int, y2):
        B = x.shape[0]
        t2 = torch.full((2 * B,), t, dtype=torch.int64, device=x.device)
        eps2 = model(torch.cat([x, x], dim=0), t2, y2)
        return eps2[:B], eps2[B:], self.scale


def reverse_sample(model: DiT, sched: NoiseSchedule,
                   strategy: ClassifierFree, *,
                   generator: torch.Generator | None = None,
                   image_size: int | None = None, channels: int = 3,
                   num_steps: int | None = None, eta: float = 1.0,
                   x_T: torch.Tensor | None = None, noise=None):
    """The ancestral/DDIM loop (paper Eq. 9): x_T ~ N(0, I); at each
    respaced t the strategy gives the score pair and the fused update
    advances x_t → x_{t−1}.

    ``x_T`` (B, H, W, C) and ``noise`` (num_steps, B, H, W, C) replace the
    generator's draws when given."""
    B = strategy.batch()
    H = image_size or 16
    num_steps = num_steps or model.dc.sample_timesteps
    ts = respaced_ts(sched.T, num_steps)
    ab_t, ab_prev = ancestral_coeffs(sched, ts)
    steps = list(zip(ts.tolist(), ab_t.tolist(), ab_prev.tolist()))
    device = strategy.y.device
    shape = (B, H, H, channels)

    x = torch.randn(shape, generator=generator, device=device) \
        if x_T is None else x_T.to(device, torch.float32)
    aux = strategy.prepare(model)
    for i, (t, abt, abp) in enumerate(steps):
        eps_c, eps_u, s = strategy.eps(model, x, t, aux)
        z = torch.randn(shape, generator=generator, device=device) \
            if noise is None else noise[i].to(device, torch.float32)
        if t == 0:
            z = torch.zeros_like(z)
        x = cfg_ops.cfg_update(x, eps_c, eps_u, s, abt, abp, z, eta)
    return torch.clamp(x, -1.0, 1.0)
