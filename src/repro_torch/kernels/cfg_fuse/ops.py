"""Public wrappers for the fused CFG update: the Triton kernels for CUDA
tensors, the plain versions (``ref.py``) for CPU tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import check_cuda_inputs
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


def step_scalars(s: float, ab_t, ab_prev, eta: float):
    """(1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ) of one reverse step:
    ``rowwise_coeffs`` of a single row, except that 1+s is rounded once
    from the host number, as the plain version rounds a Python scalar."""
    return (np.float32(1.0 + s),
            *rowwise_coeffs(s, ab_t, ab_prev, 1, eta)[1:7])


def _check_update_inputs(name, x, *others):
    check_cuda_inputs(name, x, *others)
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 elements")


def cfg_update(x, eps_c, eps_u, s: float, ab_t, ab_prev, noise,
               eta: float = 1.0):
    """Fused (1+s)·ε_c − s·ε_u guidance + ancestral update.  x, eps_c,
    eps_u and noise share one arbitrary shape; s, ab_t, ab_prev and eta
    are scalars (host numbers on the CUDA path)."""
    if x.device.type == "cpu":
        return ref.cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, noise, eta)
    _check_update_inputs("cfg_update", x, eps_c, eps_u, noise)
    out = K.cfg_update_flat(x, eps_c, eps_u, noise,
                            step_scalars(s, ab_t, ab_prev, eta))
    cfg_update.launches += 1
    return out


cfg_update.launches = 0


def cfg_update_rowwise(x, eps_c, eps_u, s, ab_t, ab_prev, noise, active,
                       eta: float = 1.0, *, row_offset: int = 0,
                       coeffs: torch.Tensor | None = None):
    """Per-row fused update for ragged waves.  ``s``, ``ab_t``, ``ab_prev``
    and ``active`` are host vectors (Bs,) that may span a wider wave than
    ``x``'s batch: tensor row b uses slot ``row_offset + b``, and a row
    whose ``active`` is not > 0 passes through bit-unchanged.  An offset
    whose window leaves the table raises ``ValueError``.

    On CUDA the kernel reads ``coeffs``, the (8, Bs) device table of
    ``rowwise_coeffs`` for these vectors, when the caller uploaded it once
    for many steps; otherwise the wrapper forms and uploads it."""
    B, Bs = x.shape[0], len(s)
    if row_offset < 0 or row_offset + B > Bs:
        raise ValueError(f"rowwise scalars span {Bs} rows; window "
                         f"[{row_offset}, {row_offset + B}) is out of range")
    if x.device.type == "cpu":
        return ref.cfg_update_rowwise_windowed(
            x, eps_c, eps_u, s, ab_t, ab_prev, noise, active, row_offset, eta)
    _check_update_inputs("cfg_update_rowwise", x, eps_c, eps_u, noise)
    if coeffs is None:
        coeffs = torch.as_tensor(rowwise_coeffs(s, ab_t, ab_prev, active,
                                                eta), device=x.device)
    if coeffs.shape != (8, Bs) or coeffs.dtype != torch.float32 \
            or coeffs.device != x.device or not coeffs.is_contiguous():
        raise ValueError(f"cfg_update_rowwise: coeffs must be a contiguous "
                         f"float32 (8, {Bs}) table on {x.device}")
    out = K.cfg_update_rowwise_flat(x, eps_c, eps_u, noise, coeffs,
                                    row_offset)
    cfg_update_rowwise.launches += 1
    return out


cfg_update_rowwise.launches = 0


def cfg_update_mixed(x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise, active,
                     eta: float = 1.0, *, row_offset: int = 0,
                     coeffs: torch.Tensor | None = None):
    """Per-row fused update for waves that mix guidance modes:
    ``cfg_update_rowwise`` plus a host vector ``mode`` (Bs,).  A row whose
    mode is < 0.5 combines (1+s)·ε_c − s·ε_u; any other row takes ``eps_c``
    as its guided ε̂.  The window contract is ``cfg_update_rowwise``'s, and
    ``coeffs`` is the (9, Bs) device table of ``mixed_coeffs``."""
    B, Bs = x.shape[0], len(s)
    if row_offset < 0 or row_offset + B > Bs:
        raise ValueError(f"mixed scalars span {Bs} rows; window "
                         f"[{row_offset}, {row_offset + B}) is out of range")
    if x.device.type == "cpu":
        return ref.cfg_update_mixed_windowed(
            x, eps_c, eps_u, mode, s, ab_t, ab_prev, noise, active,
            row_offset, eta)
    _check_update_inputs("cfg_update_mixed", x, eps_c, eps_u, noise)
    if coeffs is None:
        coeffs = torch.as_tensor(mixed_coeffs(mode, s, ab_t, ab_prev, active,
                                              eta), device=x.device)
    if coeffs.shape != (9, Bs) or coeffs.dtype != torch.float32 \
            or coeffs.device != x.device or not coeffs.is_contiguous():
        raise ValueError(f"cfg_update_mixed: coeffs must be a contiguous "
                         f"float32 (9, {Bs}) table on {x.device}")
    out = K.cfg_update_mixed_flat(x, eps_c, eps_u, noise, coeffs, row_offset)
    cfg_update_mixed.launches += 1
    return out


cfg_update_mixed.launches = 0
