"""Triton kernel: LayerNorm over d + adaLN modulation, one pass.

Replaces ``src/repro/kernels/adaln_norm/kernel.py::adaln_norm_3d`` (body
``_adaln_kernel``), run at the DiT's three modulation sites.

Bound on the H100: device-memory bytes.  Each token row of d values is
read once and written once, with ~7 flops per element.  Each program holds
``BLOCK_R`` whole token rows in registers (d padded to the next power of
two and masked), so the mean and variance are taken in fp32 without a
second read, and reads that row's batch entry of scale and shift.  Rows
are addressed through the input's batch and token strides, so the
conditioning-token-dropped view ``tok[:, 1:]`` needs no copy.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import import_triton

ELEMS_PER_PROGRAM = 4096
tl = None      # triton.language, bound by _jit() at first launch


def _adaln_kernel(x_ptr, s_ptr, b_ptr, o_ptr, rows, N, d,
                  sxb, sxn, ssb, sbb, eps,
                  BLOCK_R: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)   # flat (b, n) rows
    c = tl.arange(0, BLOCK_D)
    m = (r < rows)[:, None] & (c < d)[None, :]
    b = r // N
    n = r - b * N
    x = tl.load(x_ptr + (b * sxb + n * sxn)[:, None] + c[None, :], mask=m,
                other=0.0).to(tl.float32)
    mu = tl.sum(x, axis=1) / d
    xc = tl.where(m, x - mu[:, None], 0.0)
    var = tl.sum(xc * xc, axis=1) / d
    y = xc * tl.rsqrt(var + eps)[:, None]
    sc = tl.load(s_ptr + (b * ssb)[:, None] + c[None, :], mask=m,
                 other=0.0).to(tl.float32)
    sh = tl.load(b_ptr + (b * sbb)[:, None] + c[None, :], mask=m,
                 other=0.0).to(tl.float32)
    out = y * (1.0 + sc) + sh
    tl.store(o_ptr + r[:, None] * d + c[None, :],
             out.to(o_ptr.dtype.element_ty), mask=m)


@functools.cache
def _jit():
    global tl
    triton, tl = import_triton()
    return triton.jit(_adaln_kernel)


def adaln_norm_3d(x, scale, shift, eps: float) -> torch.Tensor:
    """x (B, N, d) with unit stride over d; scale/shift (B, d) with unit
    stride over d.  Returns a contiguous (B, N, d)."""
    B, N, d = x.shape
    out = torch.empty((B, N, d), dtype=x.dtype, device=x.device)
    block_d = 1 << max(0, (d - 1).bit_length())
    block_r = max(1, ELEMS_PER_PROGRAM // block_d)
    rows = B * N
    grid = (max(1, -(-rows // block_r)),)
    _jit()[grid](x, scale, shift, out, rows, N, d,
                 x.stride(0), x.stride(1), scale.stride(0), shift.stride(0),
                 float(eps), BLOCK_R=block_r, BLOCK_D=block_d, num_warps=4)
    return out
