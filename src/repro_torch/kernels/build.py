"""Building and loading the port's hand-written GPU kernels.

CUDA C++ sources are compiled by ``nvcc`` at first use into a shared
library with a plain C interface, loaded with ``ctypes``.  The libraries
land in ``build/`` at the root of the checkout (gitignored), each named by
a hash of its source and flags, so an edited source rebuilds and an
unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
EMPTY_SOURCE = Path(__file__).with_name("csrc") / "empty.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def nvcc_library(src: Path) -> ctypes.CDLL:
    """Compile ``src`` (once per content hash) and load it.  ptxas's
    report (registers, shared memory and spills of each kernel) is kept
    beside the library in ``build_log(src)``."""
    out = _library_path(src)
    if not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not Path(nvcc).exists():
            raise RuntimeError(f"nvcc not found; cannot build {src.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)      # atomic: no process loads a half-written file
    return ctypes.CDLL(str(out))


def compile_all(sources) -> dict:
    """Compile every source at once, one ``nvcc`` each, and return the
    seconds each took (near 0 for one already built)."""
    def one(src):
        t = time.perf_counter()
        nvcc_library(src)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(one, sources)))


def build_log(src: Path) -> str:
    """The compiler's output from the build of ``src``'s current content."""
    return _library_path(src).with_suffix(".log").read_text()


@functools.cache
def _empty_lib():
    lib = nvcc_library(EMPTY_SOURCE)
    lib.empty_launch.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def empty_launch(grid: tuple[int, int], threads: int, smem: int,
                 device: int) -> None:
    """Launch an empty kernel over ``grid`` (x, y) blocks of ``threads``
    with ``smem`` bytes of dynamic shared memory on the current stream of
    CUDA device ``device``: the launch floor of any kernel launched at
    that geometry (and no launch of any kernel's count)."""
    err = _empty_lib().empty_launch(
        grid[0], grid[1], threads, smem, device,
        torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"empty_launch failed: CUDA error {err}")


def whole_chunks(width: int, strides, ptr: int, size: int) -> bool:
    """Whether rows of ``width`` elements of ``size`` bytes, at ``strides``
    (the outer strides, in elements) from a base pointer ``ptr``, can be
    read 16 bytes at a time: the width, every stride and the pointer whole
    16-byte chunks."""
    n = 16 // size
    return width % n == 0 and ptr % 16 == 0 and not any(s % n
                                                         for s in strides)


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take: tensors off the card,
    mixed devices or dtypes, or a graph that would need a backward kernel.
    (Device indices, not ``torch.device`` objects: this runs on every
    launch, and the host's time per launch bounds the DiT's waves.)"""
    dev, dt = tensors[0].get_device(), tensors[0].dtype
    grad = torch.is_grad_enabled()
    for t in tensors:
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if t.dtype != dt:
            raise ValueError(f"{name}: mixed dtypes {dt} and {t.dtype}")
        if grad and t.requires_grad:
            raise NotImplementedError(f"{name}: the kernel has no backward; "
                                      "call it under torch.no_grad()")
