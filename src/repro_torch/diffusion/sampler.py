"""Public samplers over the reverse-process cores.

``sample_cfg`` — classifier-FREE guidance (paper Eq. 8/9): OSCAR's server
uses the uploaded category encodings ȳ_c directly as conditioning.  The
ragged forms (``sample_cfg_ragged``, ``sample_cfg_compacted``,
``sample_cfg_window``) give every row its own guidance scale and step
count, with noise keyed per row.

``sample_classifier_guided`` — classifier guidance (Eq. 4), the mechanism
of the FedCADO baseline: a gradient through a client classifier at every
step.  ``sample_uncond`` — unguided p(x) draws through the null embedding.
The mixed forms (``sample_mixed``, ``sample_mixed_compacted``,
``sample_mixed_window``) also give every row its own guidance mode and
classifier.  Samplers that may take a classifier gradient run under
``torch.no_grad()``, the others under ``torch.inference_mode()``.

Every sampler runs on the model's device.  Keys are threefry keys from
``repro_torch.prng``: (2,) uint32 for a wave, (B, 2) for per-row keys.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.guidance import (ClassifierFree, ClassifierGuided,
                                            Mixed, Unconditional, plan_epochs,
                                            ragged_tables, reverse_sample,
                                            reverse_sample_compacted,
                                            reverse_sample_mixed,
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
    return _window(model, sched, y, row_keys, guidance, num_steps, None,
                   row_offset=row_offset, window_rows=window_rows,
                   max_steps=max_steps, image_size=image_size,
                   channels=channels, eta=eta)


@torch.inference_mode()
def _window_segment(model: DiT, x, y, row_keys, guidance, ts, jloc, ab_t,
                    ab_prev, active, *, row_offset: int, image_size: int,
                    channels: int = 3, eta: float = 1.0, coeffs=None):
    """One segment of one host window of a placed classifier-free wave, the
    reference's ``_window_segment``: advance the carried rows ``x`` and
    admit the rest of ``y`` (window rows on their device), reading the
    wave-resident tables at ``row_offset`` (``reverse_sample_window``).
    Returns x unclipped."""
    return reverse_sample_window(
        model, x, _rows(model, y), row_keys, guidance, ts, jloc, ab_t,
        ab_prev, active, row_offset=row_offset, image_size=image_size,
        channels=channels, eta=eta, coeffs=coeffs)


@torch.no_grad()
def _window_segment_mixed(model: DiT, x, y, row_keys, guidance, ts, jloc,
                          ab_t, ab_prev, active, *, mode, clf_ids, labels,
                          clf_fns, row_offset: int, image_size: int,
                          channels: int = 3, eta: float = 1.0, coeffs=None):
    """``_window_segment`` of a mixed wave: ``mode`` spans the wave,
    ``clf_ids`` and ``labels`` belong to the segment's rows."""
    return reverse_sample_window(
        model, x, _rows(model, y), row_keys, guidance, ts, jloc, ab_t,
        ab_prev, active, row_offset=row_offset, image_size=image_size,
        channels=channels, eta=eta, coeffs=coeffs,
        mixed=Mixed.of(mode, clf_ids, labels, clf_fns))


def _window(model, sched, y, row_keys, guidance, num_steps, mixed, *,
            row_offset, window_rows, max_steps, image_size, channels, eta):
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
        row_offset=row_offset, image_size=H, channels=channels, eta=eta,
        mixed=mixed)
    return torch.clamp(x, -1.0, 1.0)


@torch.no_grad()
def sample_classifier_guided(model: DiT, sched: NoiseSchedule,
                             clf_logprob_fn, labels, key=None, *,
                             image_size: int | None = None,
                             channels: int = 3,
                             num_steps: int | None = None,
                             guidance: float | None = None, eta: float = 1.0,
                             x_T=None, noise=None):
    """Classifier-guided sampling (Eq. 4), the FedCADO mechanism:
    ``clf_logprob_fn(x, labels) -> (B,)`` log p(y|x) (for instance
    ``models.classifiers.classifier_logprob``), its gradient taken at the
    x̂₀ prediction.  Follows the respacing of the reference's sampler,
    which is called eagerly."""
    s = model.dc.guidance_scale if guidance is None else guidance
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                             device=model.null_y.device)
    strat = ClassifierGuided(logprob_fn=clf_logprob_fn, labels=labels,
                             scale=float(s))
    return reverse_sample(model, sched, strat, key, image_size=image_size,
                          channels=channels, num_steps=num_steps, eta=eta,
                          eager=True, x_T=x_T, noise=noise)


@torch.inference_mode()
def sample_uncond(model: DiT, sched: NoiseSchedule, num: int, key=None, *,
                  image_size: int | None = None, channels: int = 3,
                  num_steps: int | None = None, eta: float = 1.0,
                  x_T=None, noise=None):
    """Unconditional sampling: ``num`` draws from the DM's p(x)."""
    return reverse_sample(model, sched, Unconditional(num=int(num)), key,
                          image_size=image_size, channels=channels,
                          num_steps=num_steps, eta=eta, x_T=x_T, noise=noise)


@torch.no_grad()
def sample_mixed(model: DiT, sched: NoiseSchedule, y, row_keys, guidance,
                 mode, clf_ids, labels, num_steps, *, clf_fns=(),
                 max_steps: int | None = None, image_size: int | None = None,
                 channels: int = 3, eta: float = 1.0):
    """Mixed ragged wave: ``sample_cfg_ragged``'s per-row contract plus
    ``mode`` (B,) (0 classifier-free or unconditional, 1
    classifier-guided), ``clf_ids`` (B,) indices into the ``clf_fns``
    tuple and ``labels`` (B,) the classifiers' targets.  Classifier-guided
    and unconditional rows carry the null embedding as ``y``."""
    steps, S = _ragged_args(num_steps, max_steps)
    ts, ab_t, ab_prev, jloc = ragged_tables(sched, steps, S)
    return reverse_sample_mixed(model, _rows(model, y), row_keys, guidance,
                                mode, clf_ids, labels, ts, ab_t, ab_prev,
                                jloc, clf_fns=tuple(clf_fns),
                                image_size=image_size or 16,
                                channels=channels, eta=eta)


@torch.no_grad()
def sample_mixed_compacted(model: DiT, sched: NoiseSchedule, y, row_keys,
                           guidance, mode, clf_ids, labels, num_steps, *,
                           clf_fns=(), max_steps: int | None = None,
                           compaction="full", plan=None, geoms=None,
                           compile_cost: int = 256, granule: int = 1,
                           image_size: int | None = None, channels: int = 3,
                           eta: float = 1.0):
    """``sample_mixed``'s rows as nested activation epochs, the mixed
    operands permuted and sliced with the other row vectors; the same
    values as ``sample_mixed``.  Returns rows in request order."""
    steps, S = _ragged_args(num_steps, max_steps)
    if plan is None:
        plan = plan_epochs(steps, S, compaction=compaction, granule=granule,
                           geoms=geoms, compile_cost=compile_cost)
    order, epochs = plan
    ts, ab_t, ab_prev, jloc = ragged_tables(sched, steps, S)
    return reverse_sample_compacted(
        model, _rows(model, y), row_keys, guidance, ts, ab_t, ab_prev, jloc,
        epochs=epochs, order=order, image_size=image_size or 16,
        channels=channels, eta=eta, mode=mode, clf_ids=clf_ids,
        labels=labels, clf_fns=tuple(clf_fns))


@torch.no_grad()
def sample_mixed_window(model: DiT, sched: NoiseSchedule, y, row_keys,
                        guidance, mode, clf_ids, labels, num_steps, *,
                        clf_fns=(), row_offset: int,
                        window_rows: int | None = None,
                        max_steps: int | None = None,
                        image_size: int | None = None, channels: int = 3,
                        eta: float = 1.0):
    """One window of a mixed wave: ``guidance``, ``mode`` and ``num_steps``
    span the whole wave; ``y``, ``row_keys``, ``clf_ids`` and ``labels``
    carry only the window's rows."""
    mixed = Mixed.of(mode, clf_ids, labels, clf_fns)
    if len(mixed.clf_ids) != len(y) or len(mixed.labels) != len(y):
        raise ValueError(f"window carries {len(y)} rows; clf_ids has "
                         f"{len(mixed.clf_ids)} and labels "
                         f"{len(mixed.labels)}")
    if len(mixed.mode) != len(np.asarray(num_steps).reshape(-1)):
        raise ValueError("mode must span the whole wave, like num_steps")
    return _window(model, sched, y, row_keys, guidance, num_steps, mixed,
                   row_offset=row_offset, window_rows=window_rows,
                   max_steps=max_steps, image_size=image_size,
                   channels=channels, eta=eta)
