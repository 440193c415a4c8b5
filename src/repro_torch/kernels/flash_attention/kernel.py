"""ctypes binding of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``; the design note is in that file).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``
in every mode it has: causal, sliding window, logit softcap, GQA, and the
non-causal mode of the DiT.  The library is compiled by ``nvcc`` for sm_90a
at first use into ``build/`` and called with plain pointers and strides on
PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import nvcc_library

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = nvcc_library(SOURCE).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _fn()


def flash_attention_bshd(q, k, v, *, causal: bool, window: int,
                         softcap: float) -> torch.Tensor:
    """Attention of CUDA views q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd), each
    with unit stride over hd, fp32 or bf16, Hq a multiple of Hkv.  Returns
    a contiguous (B, Sq, Hq, hd) of q's type."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    # the library's runtime launches on the current device: make it q's
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, hd, int(causal),
                    int(window), float(softcap), *strides, hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed: CUDA error {err}")
    return o
