"""ctypes binding of the CUDA adaLN LayerNorm kernel
(``csrc/adaln_norm.cu``; the design notes are in the source): LayerNorm over
d + the adaLN modulation in one pass, one warp per token row.

Replaces ``src/repro/kernels/adaln_norm/kernel.py::adaln_norm_3d`` (body
``_adaln_kernel``), run at the DiT's three modulation sites.  The library is
compiled by ``nvcc`` for sm_90a at first use into ``build/`` and called with
plain pointers and a packed geometry on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import nvcc_library, whole_chunks

SOURCE = Path(__file__).with_name("csrc") / "adaln_norm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 2048                   # 64 values per lane of one warp
VALUES_PER_LANE = (8, 16, 32, 64)
MAX_SMEM = 48 * 1024


def vector_route(x) -> bool:
    """Whether the kernel reads and writes the (B, N, d) view ``x`` 16
    bytes at a time: d and the batch and token strides whole 16-byte
    chunks, the base pointer 16-byte aligned.  Otherwise one element at a
    time.  A plain function of shape, strides and pointer."""
    return whole_chunks(x.shape[2], x.stride()[:2], x.data_ptr(),
                        x.element_size())


@functools.lru_cache(maxsize=1024)
def geometry(B: int, N: int, d: int, vec: bool,
             size: int) -> tuple[int, int, int, int, int]:
    """The launch: (values per lane, token rows per block R, batch rows a
    block stages at most, blocks, shared bytes).  Block i takes the flat
    token rows [i * R, (i + 1) * R), one warp each, and stages 1 + scale
    and shift of the batch rows they fall in.  With N <= the most warps a
    block may hold (32, or 16 past 16 values per lane) a block holds whole
    batch rows, as many as make up to 16 warps (and fit 48 KB); otherwise
    R is that most and a block spans at most two batch rows."""
    n = 16 // size
    need = -(-d // (32 * n)) * n if vec else -(-d // 32)
    nv = next(v for v in VALUES_PER_LANE if v >= need)
    max_warps = 32 if nv <= 16 else 16
    if N <= max_warps:
        per = max(1, min(16 // N, MAX_SMEM // (8 * d)))
        rows, nb = N * per, per
    else:
        rows, nb = max_warps, 2
    return nv, rows, nb, -(-(B * N) // rows), 8 * nb * d


_ARGS = struct.Struct("14q")


@functools.cache
def _lib():
    lib = nvcc_library(SOURCE)
    lib.adaln_norm_fwd.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_char_p, ctypes.c_float,
                                      ctypes.c_void_p])
    lib.adaln_norm_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _lib()


def _args(x, scale, shift, ptr: int) -> bytes:
    """The packed geometry ``adaln_norm_fwd`` reads (see its source)."""
    B, N, d = x.shape
    sx, size = x.stride(), x.element_size()
    vec = whole_chunks(d, sx[:2], ptr, size)
    nv, rows, nb, _, smem = geometry(B, N, d, vec, size)
    return _ARGS.pack(DTYPES[x.dtype], B, N, d, sx[0], sx[1],
                      scale.stride(0), shift.stride(0), vec, nv, rows, nb,
                      smem, x.get_device())


def adaln_norm_3d(x, scale, shift, eps: float) -> torch.Tensor:
    """x (B, N, d) with unit stride over d; scale/shift (B, d) with unit
    stride over d; all of one type, fp32 or bf16, d <= 2048.  Returns a
    contiguous (B, N, d).  The library sets the device itself, so no
    device context is entered per call."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    ptr = x.data_ptr()
    err = _lib().adaln_norm_fwd(
        ptr, scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        _args(x, scale, shift, ptr), eps,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"adaln_norm_fwd failed: CUDA error {err}")
    return out


def empty_launch(x, scale, shift) -> None:
    """Launch an empty kernel at the grid, block and shared memory that
    ``adaln_norm_3d`` would launch for these inputs: the launch floor of
    the call (not counted as a launch of the kernel)."""
    g = _ARGS.unpack(_args(x, scale, shift, x.data_ptr()))
    # one warp a token row, g[10] rows a block (csrc/adaln_norm.cu)
    _build.empty_launch((-(-g[1] * g[2] // g[10]), 1), g[10] * 32, g[12],
                        g[13])
