"""Public samplers over the reverse-process core.

``sample_cfg`` — classifier-FREE guidance (paper Eq. 8/9): OSCAR's server
uses the uploaded category encodings ȳ_c directly as conditioning.
"""
from __future__ import annotations

import torch

from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import ClassifierFree, reverse_sample
from repro_torch.diffusion.schedule import NoiseSchedule


@torch.inference_mode()
def sample_cfg(model: DiT, sched: NoiseSchedule, y, *,
               generator: torch.Generator | None = None,
               image_size: int | None = None, channels: int = 3,
               num_steps: int | None = None, guidance: float | None = None,
               eta: float = 1.0, x_T=None, noise=None):
    """Generate images (B, H, W, C) in [-1, 1] conditioned on encodings
    ``y`` (B, cond_dim), on ``y``'s device."""
    s = model.dc.guidance_scale if guidance is None else guidance
    return reverse_sample(model, sched, ClassifierFree(y=y, scale=float(s)),
                          generator=generator, image_size=image_size,
                          channels=channels, num_steps=num_steps, eta=eta,
                          x_T=x_T, noise=noise)
