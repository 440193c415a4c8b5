"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``; the
design notes are in the source): one pass over each row, 16-byte chunks
dealt round one or more warps, a persistent grid.

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d`` (body
``_rms_kernel``).  The library is compiled by ``nvcc`` for sm_90a at first
use into ``build/`` and called with plain pointers and a packed geometry on
PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch.kernels.build import nvcc_library, whole_chunks

SOURCE = Path(__file__).with_name("csrc") / "rmsnorm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192
MAX_CHUNKS_PER_LANE = 12
WARPS = 8                        # a block; 8 / W rows at a time
WARPS_PER_ROW = (1, 2, 4, 8)


def vector_route(x) -> bool:
    """Whether the kernel reads and writes the (rows, d) view ``x`` 16
    bytes at a time: d and the row stride whole 16-byte chunks, the base
    pointer 16-byte aligned.  Otherwise one element at a time.  A plain
    function of shape, strides and pointer."""
    return whole_chunks(x.shape[1], x.stride()[:1], x.data_ptr(),
                        x.element_size())


@functools.lru_cache(maxsize=1024)
def geometry(d: int, size: int) -> tuple[int, int]:
    """(chunks a lane NV, warps a row W) for rows of d elements of ``size``
    bytes: a row is ceil(d / (16 / size)) chunks of 16 bytes, dealt round W
    warps, W the fewest of 1, 2, 4, 8 that leave each lane at most 12;
    lane l of the row's warp w holds chunks (j * W + w) * 32 + l, j < NV
    (those past the row's end empty).  The same layout serves rows read one
    element at a time."""
    chunks = -(-d // (16 // size))
    W = next(w for w in WARPS_PER_ROW
             if 32 * w * MAX_CHUNKS_PER_LANE >= chunks)
    return -(-chunks // (32 * W)), W


def rows_of_block(block: int, grid: int, rows: int, W: int):
    """The rows block ``block`` of a ``grid``-block launch normalises, in
    order, with the warps of each: warps [g * W, (g + 1) * W) take rows
    (block + i * grid) * R + g, i = 0, 1, ..., R = 8 / W at a time."""
    R = WARPS // W
    for base in range(block * R, rows, grid * R):
        for g in range(R):
            if base + g < rows:
                yield base + g, range(g * W, (g + 1) * W)


_ARGS = struct.Struct("9q")


@functools.cache
def _lib():
    lib = nvcc_library(SOURCE)
    lib.rmsnorm_fwd.argtypes = ([ctypes.c_void_p] * 3
                                + [ctypes.c_char_p, ctypes.c_float,
                                   ctypes.c_void_p])
    lib.rmsnorm_grid.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    for fn in (lib.rmsnorm_fwd, lib.rmsnorm_grid):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _lib()


def _args(x, scale, ptr: int) -> bytes:
    """The packed geometry ``rmsnorm_fwd`` reads (see its source)."""
    rows, d = x.shape
    size = x.element_size()
    nv, W = geometry(d, size)
    return _ARGS.pack(DTYPES[x.dtype], rows, d, x.stride(0),
                      whole_chunks(d, x.stride()[:1], ptr, size), nv, W,
                      DTYPES[scale.dtype], x.get_device())


def rmsnorm_2d(x, scale, eps: float) -> torch.Tensor:
    """x (rows, d) with unit stride over d, fp32 or bf16, d <= 8192; scale
    (d,) contiguous, fp32 or bf16.  Returns a contiguous (rows, d) of x's
    type.  The library sets the device itself, so no device context is
    entered per call."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ptr = x.data_ptr()
    err = _lib().rmsnorm_fwd(ptr, scale.data_ptr(), out.data_ptr(),
                             _args(x, scale, ptr), eps,
                             torch._C._cuda_getCurrentRawStream(
                                 x.get_device()))
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd failed: CUDA error {err}")
    return out


def grid(x, scale) -> int:
    """How many blocks ``rmsnorm_2d`` launches for these inputs."""
    ptr = x.data_ptr()
    n = _lib().rmsnorm_grid(_args(x, scale, ptr), ptr)
    if n < 1:
        raise RuntimeError("rmsnorm_grid failed")
    return n
