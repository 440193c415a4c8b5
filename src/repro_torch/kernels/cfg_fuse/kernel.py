"""The fused CFG guidance-combine + ancestral update kernels.

``cfg_update_flat``, ``cfg_update_rowwise_flat`` and
``cfg_update_mixed_flat`` bind the CUDA C++ kernel ``csrc/cfg_fuse.cu``
(the design notes are in the source), built by ``nvcc`` for sm_90a at
first use into ``build/`` and called through ctypes with one packed
argument block on PyTorch's current stream.  Its three variants replace
the three TPU kernels of ``src/repro/kernels/cfg_fuse/kernel.py``:

* scalar (0): ``cfg_update_2d`` (body ``_cfg_kernel``), the form that runs
  once per reverse step of a uniform wave;
* rowwise (1): ``cfg_update_rowwise_3d`` (body ``_cfg_rowwise_kernel``),
  the per-row form of ragged, compacted and windowed waves: tensor row b
  reads its step scalars from column ``row_offset + b`` of an (8, Bs)
  table that may span a whole wave, and a row whose ``active`` entry is
  not > 0 is stored back unchanged;
* mixed (2): ``cfg_update_mixed_3d`` (body ``_cfg_mixed_kernel``), the
  form of waves that mix guidance modes: the rowwise update over a (9, Bs)
  table, the eight rowwise scalars plus the row's ``mode``, where a row
  whose mode is not < 0.5 takes ε_c as its guided ε̂ (classifier guidance
  corrected it upstream) instead of the (1+s)·ε_c − s·ε_u combine.

Each variant takes the step's noise z from memory, as the TPU kernels do,
or draws it from threefry keys in registers, bit for bit as
``prng.normal``.  All round exactly where the plain versions (``ref.py``)
do: x̂₀ divides a cancelling difference by √ᾱ_t (~5e-5 at t = 999), so
one rounding more or less there moves the output by ~1e-3, and the kernel
matches the plain versions bit for bit instead of to a tolerance.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch.kernels.build import nvcc_library, whole_chunks

SOURCE = Path(__file__).with_name("csrc") / "cfg_fuse.cu"
MAX_THREADS = 512                # a block of the CUDA kernel, at most
ELEMENT_THREADS = 256            # a block, one element a thread
MAX_BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=1024)
def geometry(rows: int, n_row: int, vec: bool, sms: int) -> tuple[int, int]:
    """(blocks, threads) of the CUDA kernel over ``rows`` tensor rows of
    ``n_row`` elements on a card of ``sms`` SMs.  The launch's items are
    the 4-element chunks of each row (``vec``) or its elements, one a
    thread.  Chunks: every SM gets at most one block of just enough
    32-lane warps, up to ``MAX_THREADS``.  Elements: blocks of
    ``ELEMENT_THREADS``, so that the warps spread evenly over the SMs'
    four schedulers.  Past ``MAX_BLOCKS_PER_SM`` blocks an SM the threads
    loop over the rest (``thread_items`` replays it)."""
    items = rows * (n_row // 4 if vec else n_row)
    if vec:
        threads = min(MAX_THREADS,
                      max(32, -(-(-(-items // sms)) // 32) * 32))
    else:
        threads = min(ELEMENT_THREADS, max(32, -(-items // 32) * 32))
    return max(1, min(-(-items // threads), sms * MAX_BLOCKS_PER_SM)), threads


def thread_items(block: int, thread: int, blocks: int, threads: int,
                 rows: int, n_row: int, vec: bool):
    """The (row, first element, elements) runs that thread ``thread`` of
    block ``block`` updates, in order, as the kernel indexes: item i is
    chunk (or element) i % per_row of row i // per_row, and the thread
    takes items block * threads + thread, + blocks * threads, ...  The
    element's threefry counter is its index within the row (a scalar
    variant's one row is the whole tensor)."""
    per_row = n_row // 4 if vec else n_row
    width = 4 if vec else 1
    for i in range(block * threads + thread, rows * per_row,
                   blocks * threads):
        yield i // per_row, (i % per_row) * width, width


def vector_route(n_row: int, ptrs, keyed: bool) -> bool:
    """Whether the kernel reads and writes rows of ``n_row`` fp32 elements
    at these pointers 16 bytes at a time: z from memory (not ``keyed``),
    the row length and every pointer whole 16-byte chunks (one
    ``whole_chunks`` test of the pointers' bitwise or: this runs once per
    reverse step).  Otherwise one element a thread, as always when z is
    drawn from keys: a warp of 16-byte chunks is 128 elements, too coarse
    to spread the draw's integer work evenly over the card's 528
    schedulers at the main path's ~10^5 elements."""
    bits = 0
    for p in ptrs:
        bits |= p
    return not keyed and whole_chunks(n_row, (), bits, 4)


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# pointers (x, ε_c, ε_u, z, out, coeffs, keys, live), then n_row, rows,
# slots, row_offset, variant, keyed, vec, blocks, threads, device, the 8
# scalars and the 2 key words (csrc/cfg_fuse.cu, struct Args)
_ARGS = struct.Struct("18q8f2I")
_NO_SCALARS = (0.0,) * 8
_NO_KEY = (0, 0)


@functools.cache
def _lib():
    lib = nvcc_library(SOURCE)
    lib.cfg_fuse_fwd.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.cfg_fuse_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or load) the library without launching anything."""
    _lib()


def _args(x, eps_c, eps_u, noise, out, *, rows: int, scalars=_NO_SCALARS,
          key=_NO_KEY, coeffs=None, mixed: bool = False, row_offset: int = 0,
          keys=None, live=None) -> bytes:
    """The packed ``Args`` block of one launch (see the source), on the
    route ``vector_route`` picks: the scalar variant without ``coeffs``,
    else the rowwise one, or the mixed one for a ``mixed`` (9, Bs)
    table."""
    n_row = x.numel() // rows
    px, pc, pu, po = (x.data_ptr(), eps_c.data_ptr(), eps_u.data_ptr(),
                      out.data_ptr())
    pz = 0 if noise is None else noise.data_ptr()
    vec = vector_route(n_row, (px, pc, pu, pz, po), noise is None)
    dev = x.get_device()
    blocks, threads = geometry(rows, n_row, vec, _sms(dev))
    return _ARGS.pack(
        px, pc, pu, pz, po, 0 if coeffs is None else coeffs.data_ptr(),
        0 if keys is None else keys.data_ptr(),
        0 if live is None else live.data_ptr(), n_row, rows,
        0 if coeffs is None else coeffs.shape[1], row_offset,
        0 if coeffs is None else 1 + mixed, noise is None, vec, blocks,
        threads, dev, *scalars, *key)


def _launch(args: bytes, x) -> None:
    err = _lib().cfg_fuse_fwd(args,
                              torch._C._cuda_getCurrentRawStream(
                                  x.get_device()))
    if err != 0:
        raise RuntimeError(f"cfg_fuse_fwd failed: CUDA error {err}")


def cfg_update_flat(x, eps_c, eps_u, noise, scalars, *, key=_NO_KEY,
                    live: bool = True) -> torch.Tensor:
    """One launch over contiguous fp32 CUDA tensors of one shape.
    ``scalars`` = (1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ) as
    Python floats.  With ``noise`` None the kernel draws z from the
    threefry ``key`` (two uint32 words) over the whole tensor, or takes
    z = 0 where not ``live``."""
    out = torch.empty_like(x)
    _launch(_args(x, eps_c, eps_u, noise, out, rows=1,
                  scalars=(*scalars, 1.0 if live else 0.0), key=key), x)
    return out


def cfg_update_rowwise_flat(x, eps_c, eps_u, noise, coeffs, row_offset: int,
                            *, keys=None, live=None) -> torch.Tensor:
    """One launch over contiguous fp32 CUDA tensors (B, ...) of one shape.
    ``coeffs`` is a contiguous float32 (8, Bs) table of (1+s, s,
    √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ, active) per wave row.  With
    ``noise`` None the kernel draws row b's z from ``keys[b]`` (an int32
    (B, 2) tensor holding the uint32 key words) and multiplies it by
    ``live[b]`` (float32 (B,))."""
    out = torch.empty_like(x)
    _launch(_args(x, eps_c, eps_u, noise, out, rows=x.shape[0],
                  coeffs=coeffs, row_offset=row_offset, keys=keys,
                  live=live), x)
    return out


def cfg_update_mixed_flat(x, eps_c, eps_u, noise, coeffs, row_offset: int,
                          *, keys=None, live=None) -> torch.Tensor:
    """``cfg_update_rowwise_flat`` with a (9, Bs) table: the rowwise
    scalars plus each row's mode."""
    out = torch.empty_like(x)
    _launch(_args(x, eps_c, eps_u, noise, out, rows=x.shape[0],
                  coeffs=coeffs, mixed=True, row_offset=row_offset,
                  keys=keys, live=live), x)
    return out
