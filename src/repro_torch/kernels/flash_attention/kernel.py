"""ctypes bindings of the two CUDA flash-attention forward kernels (the
design notes are in their sources):

* ``csrc/flash_attention_tc.cu``: bf16 on the tensor cores (wgmma, TMA, a
  warp-specialised pipeline), for head dims that are multiples of 16 and
  strides TMA can address (``tensor_core_route``);
* ``csrc/flash_attention.cu``: fp32 and bf16 on the CUDA cores, any head
  dim up to 256 and any strides with a unit stride over hd.

Both replace ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_bhsd`` in every mode it has: causal, sliding window, logit
softcap, GQA, and the non-causal mode of the DiT.  Each library is compiled
by ``nvcc`` for sm_90a at first use into ``build/`` and called with plain
pointers and strides on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import nvcc_library

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
TC_SOURCE = SOURCE.with_name("flash_attention_tc.cu")
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_BLOCK_Q, TC_BLOCK_K = 128, 64      # the tensor-core kernel's tiles


def tensor_core_route(q, k, v) -> bool:
    """Whether a call goes to the tensor-core kernel: bf16, head dim a
    multiple of 16 up to 256, a unit stride over hd, every (batch, seq,
    head) stride a positive multiple of 16 bytes and every base pointer
    16-byte aligned (what a TMA tensor map takes).  A plain function of
    dtype, shape and strides."""
    hd = q.shape[-1]
    return (q.dtype == torch.bfloat16 and hd % 16 == 0
            and hd <= MAX_HEAD_DIM
            and all(t.stride(3) == 1 for t in (q, k, v))
            and all(t.stride(i) > 0 and t.stride(i) * 2 % 16 == 0
                    for t in (q, k, v) for i in range(3))
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def work_list(Sq: int, Sk: int, causal: bool, window: int) -> np.ndarray:
    """The tensor-core kernel's schedule: one (query tile, first key tile,
    end key tile) row per tile of ``TC_BLOCK_Q`` query rows, heaviest
    first.  A tile's key range is the union of what its rows (those < Sq)
    can see, rounded out to whole ``TC_BLOCK_K`` tiles; it is empty
    (first == end) when no row sees a key.  A row's keys all go to its own
    tile's block."""
    n = -(-Sq // TC_BLOCK_Q)
    rows = np.arange(n * TC_BLOCK_Q).reshape(n, TC_BLOCK_Q)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros_like(rows)
    hi = np.minimum(rows + 1, Sk) if causal else np.full_like(rows, Sk)
    seen = (lo < hi) & (rows < Sq)
    first = np.where(seen, lo, Sk).min(1)
    end = np.where(seen, hi, 0).max(1)
    kt_lo = first // TC_BLOCK_K
    kt_hi = np.where(end > first, -(-end // TC_BLOCK_K), kt_lo)
    order = np.argsort(-(kt_hi - kt_lo), kind="stable")
    return np.stack([order, kt_lo[order], kt_hi[order]],
                    1).astype(np.int32)


@functools.lru_cache(maxsize=1024)
def _work_on(device: torch.device, Sq: int, Sk: int, causal: bool,
             window: int) -> torch.Tensor:
    """``work_list`` on ``device``, built once per shape and mode."""
    return torch.as_tensor(work_list(Sq, Sk, causal, window), device=device)


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


@functools.cache
def _tc_fn():
    fn = nvcc_library(TC_SOURCE).flash_attention_tc_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_tc() -> None:
    """Compile (or load) the tensor-core library without launching."""
    _tc_fn()


def flash_attention_tc_bshd(q, k, v, *, causal: bool, window: int,
                            softcap: float) -> torch.Tensor:
    """``flash_attention_bshd`` on the tensor-core kernel, for the bf16 views
    that ``tensor_core_route`` accepts.  Returns a contiguous (B, Sq, Hq, hd)
    bf16 tensor."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    work = _work_on(q.device, Sq, Sk, bool(causal), int(window))
    with torch.cuda.device(q.device):
        err = _tc_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       B, Hq, Hkv, Sq, Sk, hd, int(causal), int(window),
                       float(softcap), *strides, hd ** -0.5, work.data_ptr(),
                       work.shape[0],
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_tc_fwd failed: CUDA error {err}")
    return o
