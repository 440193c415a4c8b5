"""Triton kernels: fused CFG guidance-combine + ancestral update.

``_cfg_kernel`` replaces ``src/repro/kernels/cfg_fuse/kernel.py::
cfg_update_2d`` (body ``_cfg_kernel``), the scalar form that runs once per
reverse step of a uniform wave.  ``_cfg_rowwise_kernel`` replaces
``cfg_update_rowwise_3d`` (body ``_cfg_rowwise_kernel``), the per-row form
of ragged, compacted and windowed waves: tensor row b reads its step
scalars from column ``row_offset + b`` of an (8, Bs) table that may span a
whole wave, and a row whose ``active`` entry is 0 is stored back
unchanged.  ``_cfg_mixed_kernel`` replaces ``cfg_update_mixed_3d`` (body
``_cfg_mixed_kernel``), the form of waves that mix guidance modes: it is
the rowwise kernel reading a (9, Bs) table, the eight rowwise scalars plus
the row's ``mode``, and a row whose mode is not < 0.5 takes ε_c as its
guided ε̂ (classifier guidance corrected it upstream) instead of the
(1+s)·ε_c − s·ε_u combine.  The TPU kernels' scalar prefetch becomes a
per-program load of the row's scalars, and their (rows, 128) lane blocks
one program per (row, ``BLOCK`` elements of that row).

Bound on the H100: device-memory bytes.  Each element reads x, ε_c, ε_u
and z and writes one output (20 bytes in fp32) for about 13 flops, far
below the card's ~20 flop/byte fp32 balance point.  The design therefore
makes exactly one pass: one program per ``BLOCK`` contiguous elements,
masked tail, no (rows, 128) lane layout or 8-row padding (those were TPU
tiling).  The per-step scalars are formed once on the host (see
``ops.rowwise_coeffs``).

The update is ill-conditioned at the first step of a short trajectory:
x̂₀ divides a cancelling difference by √ᾱ_t (~5e-5 at t = 999), so one
rounding more or less there moves the output by ~1e-3.  The kernel
therefore rounds exactly where the plain version does — multiply-add
fusion is switched off at launch and the division is IEEE-rounded — and
matches it bit for bit instead of to a tolerance.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import import_triton

BLOCK = 1024
tl = None      # triton.language, bound by _jit() at first launch


def _cfg_kernel(x_ptr, ec_ptr, eu_ptr, z_ptr, out_ptr, n, one_plus_s, s,
                sqrt_1mab, sqrt_ab, sqrt_ab_prev, dir_coef, sigma,
                BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m).to(tl.float32)
    ec = tl.load(ec_ptr + offs, mask=m).to(tl.float32)
    eu = tl.load(eu_ptr + offs, mask=m).to(tl.float32)
    z = tl.load(z_ptr + offs, mask=m).to(tl.float32)
    eps = one_plus_s * ec - s * eu
    x0 = tl.math.div_rn(x - sqrt_1mab * eps, sqrt_ab)
    x0 = tl.minimum(tl.maximum(x0, -1.0), 1.0)
    out = sqrt_ab_prev * x0 + dir_coef * eps + sigma * z
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=m)


def _cfg_rowwise_kernel(x_ptr, ec_ptr, eu_ptr, z_ptr, out_ptr, coef_ptr,
                        n_row, n_slots, row_offset, BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n_row
    idx = row * n_row + offs
    c = coef_ptr + row_offset + row       # column of this row's scalars
    one_plus_s = tl.load(c)
    s = tl.load(c + n_slots)
    sqrt_1mab = tl.load(c + 2 * n_slots)
    sqrt_ab = tl.load(c + 3 * n_slots)
    sqrt_ab_prev = tl.load(c + 4 * n_slots)
    dir_coef = tl.load(c + 5 * n_slots)
    sigma = tl.load(c + 6 * n_slots)
    active = tl.load(c + 7 * n_slots)
    x = tl.load(x_ptr + idx, mask=m).to(tl.float32)
    ec = tl.load(ec_ptr + idx, mask=m).to(tl.float32)
    eu = tl.load(eu_ptr + idx, mask=m).to(tl.float32)
    z = tl.load(z_ptr + idx, mask=m).to(tl.float32)
    eps = one_plus_s * ec - s * eu
    x0 = tl.math.div_rn(x - sqrt_1mab * eps, sqrt_ab)
    x0 = tl.minimum(tl.maximum(x0, -1.0), 1.0)
    out = sqrt_ab_prev * x0 + dir_coef * eps + sigma * z
    out = tl.where(active > 0.0, out, x)
    tl.store(out_ptr + idx, out.to(out_ptr.dtype.element_ty), mask=m)


def _cfg_mixed_kernel(x_ptr, ec_ptr, eu_ptr, z_ptr, out_ptr, coef_ptr,
                      n_row, n_slots, row_offset, BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n_row
    idx = row * n_row + offs
    c = coef_ptr + row_offset + row       # column of this row's scalars
    one_plus_s = tl.load(c)
    s = tl.load(c + n_slots)
    sqrt_1mab = tl.load(c + 2 * n_slots)
    sqrt_ab = tl.load(c + 3 * n_slots)
    sqrt_ab_prev = tl.load(c + 4 * n_slots)
    dir_coef = tl.load(c + 5 * n_slots)
    sigma = tl.load(c + 6 * n_slots)
    active = tl.load(c + 7 * n_slots)
    mode = tl.load(c + 8 * n_slots)
    x = tl.load(x_ptr + idx, mask=m).to(tl.float32)
    ec = tl.load(ec_ptr + idx, mask=m).to(tl.float32)
    eu = tl.load(eu_ptr + idx, mask=m).to(tl.float32)
    z = tl.load(z_ptr + idx, mask=m).to(tl.float32)
    eps = tl.where(mode < 0.5, one_plus_s * ec - s * eu, ec)
    x0 = tl.math.div_rn(x - sqrt_1mab * eps, sqrt_ab)
    x0 = tl.minimum(tl.maximum(x0, -1.0), 1.0)
    out = sqrt_ab_prev * x0 + dir_coef * eps + sigma * z
    out = tl.where(active > 0.0, out, x)
    tl.store(out_ptr + idx, out.to(out_ptr.dtype.element_ty), mask=m)


@functools.cache
def _jit():
    global tl
    triton, tl = import_triton()
    return triton.jit(_cfg_kernel)


@functools.cache
def _jit_rowwise():
    global tl
    triton, tl = import_triton()
    # one compiled kernel serves every window offset
    return triton.jit(_cfg_rowwise_kernel, do_not_specialize=["row_offset"])


@functools.cache
def _jit_mixed():
    global tl
    triton, tl = import_triton()
    return triton.jit(_cfg_mixed_kernel, do_not_specialize=["row_offset"])


def cfg_update_flat(x, eps_c, eps_u, noise, scalars) -> torch.Tensor:
    """One launch over contiguous CUDA tensors of one shape and dtype.
    ``scalars`` = (1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ)."""
    n = x.numel()
    out = torch.empty_like(x)
    grid = (max(1, -(-n // BLOCK)),)
    _jit()[grid](x, eps_c, eps_u, noise, out, n,
                 *(float(c) for c in scalars), BLOCK=BLOCK, num_warps=4,
                 enable_fp_fusion=False)
    return out


def cfg_update_rowwise_flat(x, eps_c, eps_u, noise, coeffs,
                            row_offset: int) -> torch.Tensor:
    """One launch over contiguous CUDA tensors (B, ...) of one shape and
    dtype.  ``coeffs`` is a contiguous float32 (8, Bs) table of
    (1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ, active) per wave row."""
    B = x.shape[0]
    n_row = x.numel() // max(B, 1)
    out = torch.empty_like(x)
    block = min(BLOCK, 1 << max(n_row - 1, 0).bit_length())
    grid = (B, max(1, -(-n_row // block)))
    _jit_rowwise()[grid](x, eps_c, eps_u, noise, out, coeffs, n_row,
                         coeffs.shape[1], int(row_offset), BLOCK=block,
                         num_warps=4, enable_fp_fusion=False)
    return out


def cfg_update_mixed_flat(x, eps_c, eps_u, noise, coeffs,
                          row_offset: int) -> torch.Tensor:
    """``cfg_update_rowwise_flat`` with a (9, Bs) table: the rowwise
    scalars plus each row's mode."""
    B = x.shape[0]
    n_row = x.numel() // max(B, 1)
    out = torch.empty_like(x)
    block = min(BLOCK, 1 << max(n_row - 1, 0).bit_length())
    grid = (B, max(1, -(-n_row // block)))
    _jit_mixed()[grid](x, eps_c, eps_u, noise, out, coeffs, n_row,
                       coeffs.shape[1], int(row_offset), BLOCK=block,
                       num_warps=4, enable_fp_fusion=False)
    return out
