"""ctypes binding of the MoE's grouped expert kernel and combine
(``csrc/moe.cu``; the design notes are in the source): a persistent wgmma
GEMM over the compact layout's row tiles, the rows of its A operand
gathered on the chip, and a one-pass weighted sum a token.

Replaces no TPU kernel (the JAX package's MoE is plain ``jnp``).  The
library is compiled by ``nvcc`` for sm_90a at first use into ``build/`` and
called with plain pointers on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import nvcc_library

SOURCE = Path(__file__).with_name("csrc") / "moe.cu"
#: rows a tile (the source's kBM): every group starts at a multiple of it
BM = 128
#: the epilogues: a plain product, silu(a·W_gate)·(a·W_up)
MODES = {"plain": 0, "gated": 1}
#: output columns a tile, by mode
BLOCK_N = {"plain": 256, "gated": 128}
MAX_TOP_K = 8


@functools.cache
def _lib():
    lib = nvcc_library(SOURCE)
    lib.moe_grouped_gemm.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.moe_combine.argtypes = ([ctypes.c_void_p] * 3
                                + [ctypes.c_int, ctypes.c_void_p]
                                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    for fn in (lib.moe_grouped_gemm, lib.moe_combine):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _lib()


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid(tiles_max: int, N: int, mode: str, device: int) -> int:
    """Blocks a grouped launch takes: one an SM, fewer where the upper
    bound holds fewer (row tile, column tile) pairs."""
    return max(1, min(_sms(device),
                      tiles_max * -(-N // BLOCK_N[mode])))


def grouped_gemm(a, a_rows, w0, w1, tile_start, group_div: int,
                 tiles_max: int, mode: str) -> torch.Tensor:
    """(tiles_max·BM, N) bf16: compact row r is ``a``'s row ``a_rows[r]``
    (r itself where ``a_rows`` is None; zeros for -1) times the weights
    (E, K, N) of its group's expert under ``mode``'s epilogue.  Checked by
    the caller (``ops.py``)."""
    E, K, N = w0.shape
    out = torch.empty((tiles_max * BM, N), dtype=torch.bfloat16,
                      device=a.device)
    dev = a.get_device()
    with torch.cuda.device(dev):
        err = _lib().moe_grouped_gemm(
            a.data_ptr(), a.stride(0),
            None if a_rows is None else a_rows.data_ptr(), w0.data_ptr(),
            None if w1 is None else w1.data_ptr(), E, out.data_ptr(),
            out.shape[0], tile_start.data_ptr(), tile_start.numel() - 1,
            group_div, K, N, MODES[mode],
            grid(tiles_max, N, mode, dev),
            torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"moe_grouped_gemm failed: CUDA error {err}")
    return out


def combine(y, rows, gates) -> torch.Tensor:
    """(tokens, d) bf16: the kernel of ``ref.combine``.  Checked by the
    caller."""
    n, k = rows.shape
    d = y.shape[1]
    out = torch.empty((n, d), dtype=torch.bfloat16, device=y.device)
    dev = y.get_device()
    with torch.cuda.device(dev):
        err = _lib().moe_combine(
            y.data_ptr(), rows.data_ptr(), gates.data_ptr(), k,
            out.data_ptr(), n, d, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"moe_combine failed: CUDA error {err}")
    return out
