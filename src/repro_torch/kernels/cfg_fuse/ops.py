"""Public wrappers for the fused CFG update: the kernels (``kernel.py``)
for CUDA tensors, the plain versions (``ref.py``) for CPU tensors.

``cfg_update``, ``cfg_update_rowwise`` and ``cfg_update_mixed`` take the
step's noise z from a tensor, or (``noise`` None) draw it from threefry
keys: on the card inside the kernel, on the CPU as their plain versions,
``prng.normal`` of the same keys and then the plain update.  Each counts
its launches in ``.launches``, the keyed ones also in ``.launches_keyed``,
and the per-row wrappers' launches at a non-zero ``row_offset`` (a host
window past the first of a placed wave) also in ``.launches_offset``.
The counters are safe to read while threads launch
(``build.count_launch``)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.build import check_cuda_inputs, count_launch
from repro_torch.kernels.cfg_fuse import kernel as K
from repro_torch.kernels.cfg_fuse import ref


def rowwise_coeffs(s, ab_t, ab_prev, active, eta: float) -> np.ndarray:
    """(..., 8, Bs) float32, or (8,) for scalars: (1+s, s, √(1−ᾱ_t), √ᾱ_t,
    √ᾱ_prev, dir_coef, σ, active) for per-row vectors (..., Bs), formed in
    float32 with the plain version's operations in its order, so the
    kernels round every scalar as ``ref.ancestral_step`` does."""
    f = np.float32
    one = f(1)
    s, ab_t, ab_prev = np.broadcast_arrays(
        *(np.asarray(v, f) for v in (s, ab_t, ab_prev)))
    with np.errstate(divide="ignore", invalid="ignore"):
        var = (one - ab_prev) / (one - ab_t) * (one - ab_t / ab_prev)
        sigma = f(eta) * np.sqrt(np.maximum(var, f(0)))
        dir_coef = np.sqrt(np.maximum(one - ab_prev - sigma * sigma, f(0)))
    act = np.broadcast_to(np.asarray(active) > 0, s.shape).astype(f)
    return np.stack([one + s, s, np.sqrt(one - ab_t), np.sqrt(ab_t),
                     np.sqrt(ab_prev), dir_coef, sigma, act],
                    axis=max(s.ndim - 1, 0))


def mixed_coeffs(mode, s, ab_t, ab_prev, active, eta: float) -> np.ndarray:
    """(..., 9, Bs) float32: the ``rowwise_coeffs`` rows of these vectors,
    then each row's ``mode`` (0 classifier-free or unconditional, 1
    classifier-guided)."""
    rows = rowwise_coeffs(s, ab_t, ab_prev, active, eta)
    m = np.broadcast_to(np.asarray(mode, np.float32),
                        rows.shape[:-2] + rows.shape[-1:])
    return np.concatenate([rows, m[..., None, :]], axis=-2)


@functools.lru_cache(maxsize=4096)
def step_scalars(s: float, ab_t: float, ab_prev: float,
                 eta: float) -> tuple[float, ...]:
    """(1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ) of one reverse step,
    float32 values as Python floats: ``rowwise_coeffs`` of a single row,
    except that 1+s is rounded once from the host number, as the plain
    version rounds a Python scalar.  Cached: every wave at one guidance
    and schedule repeats the same steps, so a step's call does no numpy
    after the first wave."""
    return (float(np.float32(1.0 + s)),
            *(float(v) for v in rowwise_coeffs(s, ab_t, ab_prev, 1,
                                               eta)[1:7]))


def key_table(keys, device) -> torch.Tensor:
    """Threefry keys (..., 2) uint32 as the int32 tensor on ``device`` that
    the rowwise kernel reads (the same 32-bit words)."""
    keys = np.ascontiguousarray(keys, np.uint32)
    return torch.as_tensor(keys.view(np.int32), device=device)


def _check_update_inputs(name, x, *others):
    """Raise on tensors the kernels do not take.  The common case (fp32,
    contiguous, one device and shape) costs one pass of four attribute
    reads a tensor: this runs once per reverse step."""
    dev, shape, f32 = x.get_device(), x.shape, torch.float32
    for t in (x, *others):
        if (t.get_device() != dev or t.dtype != f32 or t.shape != shape
                or not t.is_contiguous()):
            break
    else:
        if dev >= 0 and x.numel() < 2 ** 31 and not (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, *others))):
            return
    check_cuda_inputs(name, x, *others)
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 elements")


def _one_source(name, noise, keys):
    if (noise is None) == (keys is None):
        raise ValueError(f"{name}: give noise or noise keys, not both or "
                         f"neither")


def cfg_update(x, eps_c, eps_u, s: float, ab_t, ab_prev, noise,
               eta: float = 1.0, *, noise_key=None, live: bool = True):
    """Fused (1+s)·ε_c − s·ε_u guidance + ancestral update.  x, eps_c,
    eps_u and noise share one arbitrary shape; s, ab_t, ab_prev and eta
    are scalars (host numbers on the CUDA path).

    With ``noise`` None, z is ``prng.normal(noise_key, x.shape)`` for the
    threefry key ``noise_key`` (two uint32 words), or 0 where not ``live``
    (the t = 0 step)."""
    _one_source("cfg_update", noise, noise_key)
    if x.is_cpu:
        if noise is None:
            return ref.cfg_update_keyed(x, eps_c, eps_u, s, ab_t, ab_prev,
                                        noise_key, live, eta)
        return ref.cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, noise, eta)
    _check_update_inputs("cfg_update", x, eps_c, eps_u,
                         *(() if noise is None else (noise,)))
    if x.dtype != torch.float32:
        raise NotImplementedError(f"cfg_update on CUDA: {x.dtype}; fp32 "
                                  f"only")
    scalars = step_scalars(float(s), float(ab_t), float(ab_prev),
                           float(eta))
    if x.numel() == 0:
        return torch.empty_like(x)
    if noise is None:
        out = K.cfg_update_flat(x, eps_c, eps_u, None, scalars,
                                key=noise_key, live=live)
        count_launch(cfg_update, "launches", "launches_keyed")
    else:
        out = K.cfg_update_flat(x, eps_c, eps_u, noise, scalars)
        count_launch(cfg_update, "launches")
    return out


cfg_update.launches = 0
cfg_update.launches_keyed = 0


def _check_rows(name, B, Bs, row_offset, noise, noise_keys, live):
    """The window and noise-source contract of the per-row wrappers."""
    if row_offset < 0 or row_offset + B > Bs:
        raise ValueError(f"{name}: scalars span {Bs} rows; window "
                         f"[{row_offset}, {row_offset + B}) is out of range")
    _one_source(name, noise, noise_keys)
    if noise is None and live is None:
        raise ValueError(f"{name}: drawing from noise keys needs the rows' "
                         f"live vector")


def _launch_rows(fn, flat, x, eps_c, eps_u, noise, coeffs, make_table,
                 table_shape, row_offset, noise_keys, live):
    """The CUDA side of the per-row wrapper ``fn``: check the operands, the
    ``table_shape`` table (formed by ``make_table()`` when the caller
    passes none) and the keys, launch ``flat`` and count the launch."""
    name = fn.__name__
    _check_update_inputs(name, x, eps_c, eps_u,
                         *(() if noise is None else (noise,)))
    if x.dtype != torch.float32:
        raise NotImplementedError(f"{name} on CUDA: {x.dtype}; fp32 only")
    dev, B = x.get_device(), x.shape[0]
    if coeffs is None:
        coeffs = torch.as_tensor(make_table(), device=x.device)
    if coeffs.shape != table_shape or coeffs.dtype != torch.float32 \
            or coeffs.get_device() != dev or not coeffs.is_contiguous():
        raise ValueError(f"{name}: coeffs must be a contiguous float32 "
                         f"{table_shape} table on {x.device}")
    if noise is None and (
            noise_keys.shape != (B, 2) or noise_keys.dtype != torch.int32
            or live.shape != (B,) or live.dtype != torch.float32
            or noise_keys.get_device() != dev or live.get_device() != dev
            or not (noise_keys.is_contiguous() and live.is_contiguous())):
        raise ValueError(f"{name}: noise_keys must be a contiguous int32 "
                         f"({B}, 2) and live a contiguous float32 ({B},) "
                         f"tensor on {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    out = flat(x, eps_c, eps_u, noise, coeffs, row_offset, keys=noise_keys,
               live=live)
    count_launch(fn, "launches", *(("launches_keyed",) if noise is None
                                   else ()),
                 *(("launches_offset",) if row_offset else ()))
    return out


def cfg_update_rowwise(x, eps_c, eps_u, s, ab_t, ab_prev, noise, active,
                       eta: float = 1.0, *, row_offset: int = 0,
                       coeffs: torch.Tensor | None = None, noise_keys=None,
                       live=None):
    """Per-row fused update for ragged waves.  ``s``, ``ab_t``, ``ab_prev``
    and ``active`` are host vectors (Bs,) that may span a wider wave than
    ``x``'s batch: tensor row b uses slot ``row_offset + b``, and a row
    whose ``active`` is not > 0 passes through bit-unchanged.  An offset
    whose window leaves the table raises ``ValueError``.

    With ``noise`` None, row b's z is ``prng.normal(noise_keys[b],
    x.shape[1:])`` times ``live[b]``: ``noise_keys`` is an int32 (B, 2)
    tensor of the tensor rows' threefry keys (``key_table``) and ``live``
    a float32 (B,) tensor of 1 and 0, both on x's device.

    On CUDA the kernel reads ``coeffs``, the (8, Bs) device table of
    ``rowwise_coeffs`` for these vectors, when the caller uploaded it once
    for many steps; otherwise the wrapper forms and uploads it."""
    Bs = len(s)
    _check_rows("cfg_update_rowwise", x.shape[0], Bs, row_offset, noise,
                noise_keys, live)
    if x.is_cpu:
        if noise is None:
            noise = ref.row_noise(noise_keys, live, x.shape[1:], x.device)
        return ref.cfg_update_rowwise_windowed(
            x, eps_c, eps_u, s, ab_t, ab_prev, noise, active, row_offset, eta)
    return _launch_rows(
        cfg_update_rowwise, K.cfg_update_rowwise_flat, x, eps_c, eps_u,
        noise, coeffs, lambda: rowwise_coeffs(s, ab_t, ab_prev, active, eta),
        (8, Bs), row_offset, noise_keys, live)


cfg_update_rowwise.launches = 0
cfg_update_rowwise.launches_keyed = 0
cfg_update_rowwise.launches_offset = 0


def cfg_update_mixed(x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise, active,
                     eta: float = 1.0, *, row_offset: int = 0,
                     coeffs: torch.Tensor | None = None, noise_keys=None,
                     live=None):
    """Per-row fused update for waves that mix guidance modes:
    ``cfg_update_rowwise`` plus a host vector ``mode`` (Bs,).  A row whose
    mode is < 0.5 combines (1+s)·ε_c − s·ε_u; any other row takes ``eps_c``
    as its guided ε̂.  The window, noise and key contract is
    ``cfg_update_rowwise``'s, and ``coeffs`` is the (9, Bs) device table of
    ``mixed_coeffs``."""
    Bs = len(s)
    _check_rows("cfg_update_mixed", x.shape[0], Bs, row_offset, noise,
                noise_keys, live)
    if x.is_cpu:
        if noise is None:
            noise = ref.row_noise(noise_keys, live, x.shape[1:], x.device)
        return ref.cfg_update_mixed_windowed(
            x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise, active,
            row_offset, eta)
    return _launch_rows(
        cfg_update_mixed, K.cfg_update_mixed_flat, x, eps_c, eps_u, noise,
        coeffs, lambda: mixed_coeffs(mode, s, ab_t, ab_prev, active, eta),
        (9, Bs), row_offset, noise_keys, live)


cfg_update_mixed.launches = 0
cfg_update_mixed.launches_keyed = 0
cfg_update_mixed.launches_offset = 0
