"""Public samplers over the reverse-process cores.

``sample_cfg`` — classifier-FREE guidance (paper Eq. 8/9): OSCAR's server
uses the uploaded category encodings ȳ_c directly as conditioning.  The
ragged forms (``sample_cfg_ragged``, ``sample_cfg_compacted``,
``sample_cfg_window``) give every row its own guidance scale and step
count, with noise keyed per row.

Every sampler runs on the model's device.  Keys are threefry keys from
``repro_torch.prng``: (2,) uint32 for a wave, (B, 2) for per-row keys.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import (ClassifierFree, plan_epochs,
                                            ragged_tables, reverse_sample,
                                            reverse_sample_compacted,
                                            reverse_sample_ragged,
                                            reverse_sample_window)
from repro_torch.diffusion.schedule import NoiseSchedule


def _rows(model: DiT, y) -> torch.Tensor:
    return torch.as_tensor(y, dtype=torch.float32,
                           device=model.null_y.device)


def _ragged_args(num_steps, max_steps):
    steps = np.asarray(num_steps, np.int32).reshape(-1)
    return steps, int(max_steps if max_steps is not None else steps.max())


@torch.inference_mode()
def sample_cfg(model: DiT, sched: NoiseSchedule, y, key=None, *,
               image_size: int | None = None, channels: int = 3,
               num_steps: int | None = None, guidance: float | None = None,
               eta: float = 1.0, x_T=None, noise=None):
    """Generate images (B, H, W, C) in [-1, 1] conditioned on encodings
    ``y`` (B, cond_dim), drawing x_T and the step noise from ``key``."""
    s = model.dc.guidance_scale if guidance is None else guidance
    return reverse_sample(model, sched,
                          ClassifierFree(y=_rows(model, y), scale=float(s)),
                          key, image_size=image_size, channels=channels,
                          num_steps=num_steps, eta=eta, x_T=x_T, noise=noise)


@torch.inference_mode()
def sample_cfg_ragged(model: DiT, sched: NoiseSchedule, y, row_keys,
                      guidance, num_steps, *, max_steps: int | None = None,
                      image_size: int | None = None, channels: int = 3,
                      eta: float = 1.0):
    """Ragged classifier-free wave: ``y`` (B, cond_dim), ``row_keys``
    (B, 2), ``guidance`` (B,) and ``num_steps`` (B,), one entry per row,
    in one trajectory of ``max_steps`` (default: the largest step count)
    iterations.  A row's result depends only on its own (encoding,
    guidance, steps, key)."""
    steps, S = _ragged_args(num_steps, max_steps)
    ts, ab_t, ab_prev, jloc = ragged_tables(sched, steps, S)
    return reverse_sample_ragged(model, _rows(model, y), row_keys, guidance,
                                 ts, ab_t, ab_prev, jloc,
                                 image_size=image_size or 16,
                                 channels=channels, eta=eta)


@torch.inference_mode()
def sample_cfg_compacted(model: DiT, sched: NoiseSchedule, y, row_keys,
                         guidance, num_steps, *,
                         max_steps: int | None = None, compaction="full",
                         plan=None, geoms=None, compile_cost: int = 256,
                         granule: int = 1, image_size: int | None = None,
                         channels: int = 3, eta: float = 1.0):
    """``sample_cfg_ragged``'s rows, run as nested activation epochs so
    frozen rows stop riding the denoiser.  ``compaction``, ``geoms``,
    ``compile_cost`` and ``granule`` go to ``plan_epochs``; ``plan`` (its
    ``(order, epochs)``) reuses a plan the caller already made.  Returns
    rows in request order."""
    steps, S = _ragged_args(num_steps, max_steps)
    if plan is None:
        plan = plan_epochs(steps, S, compaction=compaction, granule=granule,
                           geoms=geoms, compile_cost=compile_cost)
    order, epochs = plan
    ts, ab_t, ab_prev, jloc = ragged_tables(sched, steps, S)
    return reverse_sample_compacted(
        model, _rows(model, y), row_keys, guidance, ts, ab_t, ab_prev, jloc,
        epochs=epochs, order=order, image_size=image_size or 16,
        channels=channels, eta=eta)


@torch.inference_mode()
def sample_cfg_window(model: DiT, sched: NoiseSchedule, y, row_keys,
                      guidance, num_steps, *, row_offset: int,
                      window_rows: int | None = None,
                      max_steps: int | None = None,
                      image_size: int | None = None, channels: int = 3,
                      eta: float = 1.0):
    """One window of a ragged wave.  ``guidance`` (B,) and ``num_steps``
    (B,) span the whole wave (the wave-resident scalar table); ``y`` and
    ``row_keys`` carry only the window's rows
    ``[row_offset, row_offset + window_rows)``.  The fused update reads
    each row's scalars at wave slot ``row_offset + b``."""
    steps, S = _ragged_args(num_steps, max_steps)
    Bw = int(window_rows if window_rows is not None else len(y))
    if len(y) != Bw or len(row_keys) != Bw:
        raise ValueError(f"window carries {Bw} rows; y has {len(y)} "
                         f"and row_keys {len(row_keys)}")
    if row_offset < 0 or row_offset + Bw > len(steps):
        raise ValueError(f"window [{row_offset}, {row_offset + Bw}) is out "
                         f"of range for a {len(steps)}-row wave")
    ts, ab_t, ab_prev, jloc = ragged_tables(sched, steps, S)
    w = slice(row_offset, row_offset + Bw)
    H = image_size or 16
    y = _rows(model, y)
    x = reverse_sample_window(
        model, torch.zeros((0, H, H, channels), device=y.device), y,
        row_keys, guidance, ts[w], jloc[w], ab_t, ab_prev, jloc >= 0,
        row_offset=row_offset, image_size=H, channels=channels, eta=eta)
    return torch.clamp(x, -1.0, 1.0)
