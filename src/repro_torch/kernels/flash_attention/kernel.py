"""ctypes bindings of the three CUDA flash-attention forward kernels (the
design notes are in their sources):

* ``csrc/flash_attention_short.cu``: fp32 and bf16 at Sq, Sk <= 32 and head
  dim <= 64, one exact pass with every key on chip (``short_seq_route``):
  the DiT's attention;
* ``csrc/flash_attention_tc.cu``: bf16 on the tensor cores (wgmma, TMA, a
  warp-specialised pipeline), for head dims that are multiples of 16 and
  strides TMA can address (``tensor_core_route``);
* ``csrc/flash_attention.cu``: fp32 and bf16 on the CUDA cores, register-
  tiled like an SGEMM, any head dim up to 256 (``cuda_core_geometry``) and
  any strides with a unit stride over hd: every other call.

All three replace ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_bhsd`` in every mode it has: causal, sliding window, logit
softcap, GQA, and the non-causal mode of the DiT.  Each library is compiled
by ``nvcc`` for sm_90a at first use into ``build/`` and called with plain
pointers and strides on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import nvcc_library, whole_chunks

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
TC_SOURCE = SOURCE.with_name("flash_attention_tc.cu")
SHORT_SOURCE = SOURCE.with_name("flash_attention_short.cu")
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_BLOCK_Q, TC_BLOCK_K = 128, 64      # the tensor-core kernel's tiles
# the short kernel: one query row per lane and every key on chip (S <= 32);
# a lane's q row and accumulators in registers (hd <= 64); at most 8 warps
# (one per query head) and 48 KB of shared memory a block
SHORT_MAX_S, SHORT_MAX_HEAD_DIM = 32, 64
SHORT_MAX_WARPS, SHORT_MAX_SMEM = 8, 48 * 1024


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


def short_seq_route(q, k, v) -> bool:
    """Whether a call goes to the short-sequence kernel: fp32 or bf16, Sq
    and Sk at most 32, head dim at most 64, and a unit stride over hd.  A
    plain function of dtype, shape and strides; any (batch, seq, head)
    strides and pointers are taken, and ``vector_loads`` decides, per
    tensor, whether it is read 16 bytes at a time."""
    return (q.dtype in DTYPES and q.shape[1] <= SHORT_MAX_S
            and k.shape[1] <= SHORT_MAX_S
            and q.shape[3] <= SHORT_MAX_HEAD_DIM
            and q.stride(3) == k.stride(3) == v.stride(3) == 1)


def vector_loads(t) -> bool:
    """Whether the short kernel reads the (B, S, H, hd) view ``t`` 16 bytes
    at a time: hd and its (batch, seq, head) strides whole 16-byte chunks,
    its base pointer 16-byte aligned.  Otherwise it reads one element at a
    time."""
    return whole_chunks(t.shape[3], t.stride()[:3], t.data_ptr(),
                        t.element_size())


@functools.lru_cache(maxsize=1024)
def short_geometry(Hq: int, Hkv: int, Sq: int, Sk: int,
                   hd: int) -> tuple[int, int, int]:
    """The short kernel's launch: (query heads per block hb, kv heads a
    block stages at most, shared bytes).  Block (x, b) takes batch element
    b and query heads [x * hb, min((x + 1) * hb, Hq)), one warp each (lane
    i: query row i), and stages the kv heads h // (Hq // Hkv) of those
    heads; the grid is (ceil(Hq / hb), B).  hb is the most heads, up to 8,
    whose q, k, v and score scratch fit in 48 KB; one head always fits."""
    rep, hdp = Hq // Hkv, -(-hd // 4) * 4
    hb = min(Hq, SHORT_MAX_WARPS)
    while True:
        nkv = max((h0 + min(hb, Hq - h0) - 1) // rep - h0 // rep + 1
                  for h0 in range(0, Hq, hb))
        smem = 4 * (hdp * (hb * Sq + 2 * nkv * Sk) + hb * Sk * 32)
        if smem <= SHORT_MAX_SMEM or hb == 1:
            return hb, nkv, smem
        hb = -(-hb // 2)


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
def _scale(hd: int) -> float:
    return hd ** -0.5


# the CUDA-core kernel (CUDA_CORE_THREADS a block, the source's kThreads):
# per head-dim class (hd rounded up to the class, columns past hd zeros) the
# query rows BM and keys BN of a tile (the source's Tiles)
CUDA_CORE_THREADS = 256
CUDA_CORE_TILES = {16: (128, 64), 32: (128, 64), 48: (128, 32),
                   64: (128, 32), 96: (64, 64), 128: (64, 64), 256: (64, 32)}
MAX_SMEM = 232448                 # what one block may use on an H100


def cuda_core_smem(hdp: int) -> int:
    """Shared bytes of a CUDA-core block of class ``hdp``: Q, two stages of
    K and V (rows hdp + 4 floats apart), P transposed (rows BM + 4 apart),
    and two per-row vectors."""
    bm, bn = CUDA_CORE_TILES[hdp]
    ld = hdp + 4
    return 4 * (bm * ld + 4 * bn * ld + bn * (bm + 4) + 2 * bm)


@functools.lru_cache(maxsize=1024)
def cuda_core_geometry(B: int, Hq: int, Hkv: int, Sq: int,
                       hd: int) -> tuple[int, ...]:
    """The CUDA-core kernel's launch: (class hdp, BM, BN, heads a block G,
    positions a block P, position tiles, blocks, shared bytes).  A block
    takes G query heads of one kv head (G the largest power of two dividing
    Hq / Hkv with 16 * G <= BM) at P = BM / G consecutive positions; the
    grid is one-dimensional, see ``cuda_core_blocks``."""
    hdp = next(c for c in CUDA_CORE_TILES if hd <= c)
    bm, bn = CUDA_CORE_TILES[hdp]
    rep, G = Hq // Hkv, 1
    while rep % (2 * G) == 0 and 32 * G <= bm:
        G *= 2
    P = bm // G
    n_pt = -(-Sq // P)
    return (hdp, bm, bn, G, P, n_pt, n_pt * B * Hkv * (rep // G),
            cuda_core_smem(hdp))


def cuda_core_blocks(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, hd: int,
                     causal: bool, window: int):
    """Each block of the CUDA-core launch in launch order, as the kernel
    computes it: (batch b, first query head h0, first position q0, first
    key, end key).  Row r of the block is query head h0 + r // P at
    position q0 + r % P (rows past Sq are not stored); its keys are the
    whole BN-key tiles that some row of the block sees, [first, end) (empty
    when no row sees a key).  Position tiles go heaviest first: last first
    under a causal mask, else first first (a window alone leaves the first
    positions the most keys)."""
    _, _, bn, G, P, n_pt, blocks, _ = cuda_core_geometry(B, Hq, Hkv, Sq, hd)
    rep = Hq // Hkv
    ng = rep // G
    nbh = B * Hkv * ng
    for bid in range(blocks):
        rank, bh = divmod(bid, nbh)
        b, hk, gi = bh // (Hkv * ng), (bh // ng) % Hkv, bh % ng
        q0 = (n_pt - 1 - rank if causal else rank) * P
        pos_hi = min(q0 + P, Sq) - 1
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(Sk, pos_hi + 1) if causal else Sk
        kt0 = lo // bn
        nt = -(-hi // bn) - kt0 if hi > lo else 0
        yield b, hk * rep + gi * G, q0, kt0 * bn, (kt0 + nt) * bn


_CC_ARGS = struct.Struct("26q")


@functools.cache
def _lib():
    lib = nvcc_library(SOURCE)
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_char_p, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_occupancy.argtypes = [ctypes.c_int] * 3
    for fn in (lib.flash_attention_fwd, lib.flash_attention_occupancy):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _lib()


def _cuda_core_args(q, k, v, ptrs, causal: bool, window: int) -> bytes:
    """The packed geometry ``flash_attention_fwd`` reads (see its source):
    shapes, mode, strides, the 16-byte read of each input, the launch and
    the device."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    size = q.element_size()
    hdp, _, _, G, _, _, blocks, smem = cuda_core_geometry(B, Hq, Hkv, Sq, hd)
    return _CC_ARGS.pack(
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, hd, causal, window,
        sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
        whole_chunks(hd, sq[:3], ptrs[0], size),
        whole_chunks(hd, sk[:3], ptrs[1], size),
        whole_chunks(hd, sv[:3], ptrs[2], size),
        hdp, G, blocks, smem, q.get_device())


def flash_attention_bshd(q, k, v, *, causal: bool, window: int,
                         softcap: float) -> torch.Tensor:
    """Attention of CUDA views q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd), each
    with unit stride over hd, fp32 or bf16, Hq a multiple of Hkv, on the
    CUDA-core kernel.  Returns a contiguous (B, Sq, Hq, hd) of q's type.
    The library sets the device itself, so no device context is entered
    per call."""
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    err = _lib().flash_attention_fwd(
        *ptrs, o.data_ptr(), _cuda_core_args(q, k, v, ptrs, causal, window),
        softcap, _scale(q.shape[3]),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed: CUDA error {err}")
    return o


def cuda_core_empty_launch(q, k, v) -> None:
    """Launch an empty kernel at the grid, block and shared memory that
    ``flash_attention_bshd`` would launch for these inputs: the launch
    floor of the call (not counted as a launch of the kernel)."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    g = _CC_ARGS.unpack(_cuda_core_args(q, k, v, ptrs, False, 0))
    _build.empty_launch((g[23], 1), CUDA_CORE_THREADS, g[24], g[25])


def cuda_core_occupancy(dtype: torch.dtype, hdp: int, device: int) -> int:
    """How many blocks of the CUDA-core instance (``dtype``, class ``hdp``)
    fit on one SM of CUDA device ``device`` at once (CUDA's occupancy
    calculator)."""
    n = _lib().flash_attention_occupancy(DTYPES[dtype], hdp, device)
    if n < 0:
        raise RuntimeError("flash_attention_occupancy failed")
    return n


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


_SHORT_ARGS = struct.Struct("25q")


@functools.cache
def _short_lib():
    lib = nvcc_library(SHORT_SOURCE)
    lib.flash_attention_short_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_char_p, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_short_occupancy.argtypes = [ctypes.c_char_p]
    lib.flash_attention_short_memory_only.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_char_p, ctypes.c_void_p])
    for fn in (lib.flash_attention_short_fwd,
               lib.flash_attention_short_occupancy,
               lib.flash_attention_short_memory_only):
        fn.restype = ctypes.c_int
    return lib


def build_short() -> None:
    """Compile (or load) the short-sequence library without launching."""
    _short_lib()


def _short_args(q, k, v, ptrs, causal: bool, window: int) -> bytes:
    """The packed geometry ``flash_attention_short_fwd`` reads (see its
    source): shapes, mode, strides, the 16-byte read of each input, the
    launch and the device."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    size = q.element_size()
    return _SHORT_ARGS.pack(
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, hd, causal, window,
        sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
        whole_chunks(hd, sq[:3], ptrs[0], size),
        whole_chunks(hd, sk[:3], ptrs[1], size),
        whole_chunks(hd, sv[:3], ptrs[2], size),
        *short_geometry(Hq, Hkv, Sq, Sk, hd), q.get_device())


def flash_attention_short_bshd(q, k, v, *, causal: bool, window: int,
                               softcap: float) -> torch.Tensor:
    """``flash_attention_bshd`` on the short-sequence kernel, for the calls
    ``short_seq_route`` accepts.  Returns a contiguous (B, Sq, Hq, hd) of
    q's type.  The library sets the device itself, so no device context is
    entered per call."""
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    err = _short_lib().flash_attention_short_fwd(
        *ptrs, o.data_ptr(), _short_args(q, k, v, ptrs, causal, window),
        softcap, _scale(q.shape[3]),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_short_fwd failed: CUDA error "
                           f"{err}")
    return o


def short_empty_launch(q, k, v) -> None:
    """Launch an empty kernel at the grid, block and shared memory that
    ``flash_attention_short_bshd`` would launch for these inputs: the
    launch floor of the call (not counted as a launch of the kernel)."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    g = _SHORT_ARGS.unpack(_short_args(q, k, v, ptrs, False, 0))
    # g[21] warps a block, one query head each, over (head groups, batch)
    _build.empty_launch((-(-g[2] // g[21]), g[1]), g[21] * 32, g[23], g[24])


def short_occupancy(q, k, v) -> int:
    """How many blocks of ``flash_attention_short_bshd``'s launch for these
    inputs fit on one SM at once (CUDA's occupancy calculator)."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    n = _short_lib().flash_attention_short_occupancy(
        _short_args(q, k, v, ptrs, False, 0))
    if n < 0:
        raise RuntimeError("flash_attention_short_occupancy failed")
    return n


def short_memory_only_launch(q, k, v) -> None:
    """Launch the short kernel for these inputs without its compute: q, k
    and v staged and an output stored, at the same grid, block and shared
    memory.  What the memory phases cost (not counted as a launch)."""
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    err = _short_lib().flash_attention_short_memory_only(
        *ptrs, o.data_ptr(), _short_args(q, k, v, ptrs, False, 0),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_short_memory_only failed: CUDA "
                           f"error {err}")
