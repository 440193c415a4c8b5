"""Triton kernel: RMSNorm over the last dimension, one pass.

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d`` (body
``_rms_kernel``).

Bound on the H100: device-memory bytes.  Each row of d values is read once
and written once, with ~4 flops per element; at the LM's (18432, 2304) in
bf16 that is 170 MB, 51 µs at 3.35 TB/s.  Each program holds ``BLOCK_R``
whole rows in registers (d padded to the next power of two and masked, up
to 8192), so the mean of squares is taken in fp32 without a second read of
the row, and reads the (d,) scale once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import import_triton

MAX_D = 8192
ELEMS_PER_PROGRAM = 4096
tl = None      # triton.language, bound by _jit() at first launch


def _rms_kernel(x_ptr, s_ptr, o_ptr, rows, d, sxr, eps,
                BLOCK_R: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.arange(0, BLOCK_D)
    m = (r < rows)[:, None] & (c < d)[None, :]
    x = tl.load(x_ptr + (r * sxr)[:, None] + c[None, :], mask=m,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / d
    y = x * tl.rsqrt(var + eps)[:, None]
    sc = tl.load(s_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    out = y * (1.0 + sc)[None, :]
    tl.store(o_ptr + r[:, None] * d + c[None, :],
             out.to(o_ptr.dtype.element_ty), mask=m)


@functools.cache
def _jit():
    global tl
    triton, tl = import_triton()
    return triton.jit(_rms_kernel)


def rmsnorm_2d(x, scale, eps: float) -> torch.Tensor:
    """x (rows, d) with unit stride over d; scale (d,) contiguous.
    Returns a contiguous (rows, d)."""
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    block_d = 1 << max(0, (d - 1).bit_length())
    block_r = max(1, ELEMS_PER_PROGRAM // block_d)
    grid = (max(1, -(-rows // block_r)),)
    _jit()[grid](x, scale, out, rows, d, x.stride(0), float(eps),
                 BLOCK_R=block_r, BLOCK_D=block_d,
                 num_warps=8 if block_d >= 2048 else 4)
    return out
