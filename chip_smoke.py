#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. card check, build of every kernel (nvcc for the six CUDA sources
     and the empty kernel of the launch floors, all started together),
     with the build seconds and ptxas's report (neither the tensor-core
     flash kernel nor any of the CUDA-core flash kernel's 14 instances nor
     any of cfg_fuse.cu's six may spill), then each kernel's first launch;
  2. each kernel against its plain PyTorch version at the main path's
     shapes and at edge shapes, with kernel (per call and on the device),
     plain and library times (per call and, where there is a library
     call, on the device), the card's lower bound for the same work (bytes
     and fp32 or bf16 operations; the keyed cfg rows also print an int32
     estimate), and the launch floor (``build.empty_launch`` at the same
     launch); the three cfg variants (scalar, rowwise, mixed) in both
     noise modes (z from memory, z drawn from threefry keys), bit-equal
     to their plain versions; for the DiT's two kernels and the cfg
     kernels what their bindings cost on the host; the DiT's
     attention also through the CUDA-core kernel it replaced; the
     CUDA-core kernel at the DiT's 224-px length (4, 3137, 4, 32) beside
     SDPA and its launch floor, at its tile edges in every mode, and its
     instances (registers, shared bytes, blocks an SM);
  3. the DiT at the paper preset's full width (d_model 144, 4 layers,
     4 heads, patch 4, 512-d conditioning, 16 px, batch 256) on seeded
     weights perturbed 0.05·normal: kernel path against plain path, and
     a call's host and device time;
     3b. a ResNet-18 classifier's forward pass and input gradient at
     B = 120 on the card against the CPU run of the same weights;
  4. the slice: federated data → client encodings → D_syn synthesis
     (6 clients × 10 categories × 30 samples, 50 steps, guidance 2.0,
     waves of at most 128: 15 waves of 120), twice from one
     threefry key, with launch counts checked against the path each time
     (every DiT attention on the short-sequence kernel), then a 4-step
     wave on the kernel path against the plain DiT on the same draws
     (every uniform step's noise is drawn in the update kernel, counted in
     ``cfg_update.launches_keyed``);
  5. one 128-row wave through ``synthesize`` under the profiler: the
     device's busy time in the trace against the wave's wall time;
  6. ragged synthesis at the same width: the same 60 uploads at mixed
     (guidance, steps) — (1.5, 50), (4.0, 50), (7.5, 25), (1.5, 25) in
     turn, 30 samples each — through the engine as one-shot ragged waves
     and as fully compacted waves, two rounds each, with row-iteration
     and launch counts checked; ragged against compacted D_syn; one wave
     as two windows against the whole wave; a 4-step ragged wave on the
     kernel path against the plain DiT (every rowwise update draws its
     noise in the kernel); the cost of the threefry draws that stay eager;
  7. mixed guidance modes (the reference benchmark's
     ``_bench_mixed_guidance`` request set): the 60 uploads of phase 6,
     one classifier-guided request per category (guidance 1.0, 25 or 50
     steps by category parity, two seeded ResNet-18 classifiers chosen
     by parity) and four unconditional requests, 30 samples each, served
     as merged ragged and merged compacted waves, with stats and launch
     counts checked against a plan computed here (every step's noise drawn
     in the update kernels, mixed waves' in the mixed variant, counted in
     ``launches_keyed``), the SHA-256 of the first ragged round's D_syn,
     merged against isolated-mode D_syn, ragged against compacted, a
     4-step mixed wave on the kernel path against the plain DiT, and one
     traced mixed wave;
     7b. the DiT at the paper's 224 px (S = 3137, the preset's width, 4
     layers, batch 8): kernel path against plain path, every attention on
     the CUDA-core kernel, the call's device time and attention's share;
  8. LM serving, gemma2-2b at full width and depth (26 layers, d 2304,
     8/4 heads of 256, vocab 256000) on seeded random weights:
     8a. flash attention's mode grid (causal, window, softcap, GQA with
         and without window, MQA, non-causal; head dims 64/128/256;
         S = 100 and 4608; fp32 through the CUDA-core kernel and bf16
         through the tensor-core kernel, bf16 also gated row by row
         relative to the row's size) and rmsnorm against their plain
         versions, and both timed at the serving shapes, beside
         ``flex_attention`` (the same function, compiled) and SDPA (a
         different one);
     8b. ``ServeEngine`` in bf16, two rounds of a wave of 4 × 4608-token
         prompts (32 new tokens each) and a wave of 16 × 512 (64 each),
         with stats and flash launches checked (26 per prefill, all on
         the tensor cores, none in decode), the same tokens in both
         rounds, and one traced prefill (with the flash kernel's share of
         its device time) and decode step (its device time);
     8c. one 4608-token request in fp32 through the kernel route (the
         CUDA-core flash kernel, its launches counted) and the plain route
         on the same weights: last-position logits gated, greedy tokens
         compared.
Phases 4 and 6 run two rounds each, phase 7 two per schedule, phase 8b
two.
The last line is the result; the line before it names the card.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import copy
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
# H100 SXM int32 outside the tensor cores, an estimate no run has checked:
# 64 lanes an SM (half the fp32 lanes; Hopper architecture white paper) x
# 132 SMs x 1.98 GHz.  Used only for the int32 part of the keyed cfg rows'
# bound split (printed in phase 2); bound_ms comes from the rates above
INT32_OPS = 64 * 132 * 1.98e9
TOL_CFG, TOL_ADALN, TOL_ATTN = 1e-6, 1e-5, 2e-5
TOL_ATTN_BF16, TOL_RMS, TOL_RMS_BF16 = 2e-2, 1e-5, 5e-2
# bf16 attention, besides the absolute gate: kernel and plain version both
# round an fp32 result once, so each element differs by at most one bf16
# ulp (at most 2^-7 of its size); gate each output row at two ulps of its
# largest value.  At S = 4608 a row averages ~4096 values of v and is ~0.02
# in size, below the absolute gate; a window edge off by one moves it by
# far more than 2^-6 of its largest value
TOL_ATTN_BF16_ROW = 2.0 ** -6
# adaln_norm in bf16: kernel and plain version (in fp32 on the same bf16
# inputs) each give an fp32 result, the kernel rounds it once, so an element
# differs by one bf16 ulp (2^-7 of its size) plus the fp32 gate: where the
# shift cancels the scaled term, |y| is small and the fp32 roundings of the
# two orders (the kernel fuses the multiply-add) dominate
TOL_ADALN_BF16_ULP = 2.0 ** -7
# 8c: last-position logits of a 26-layer fp32 prefill, kernel route against
# plain route.  Each attention layer differs by ~1e-6 relative (fp32 sums
# in another order); 26 layers of a random-weight residual stream carry
# that to the logits (|logit| < 30 after the final soft cap)
TOL_LM_LOGITS = 1e-3
TOL_DIT, TOL_E2E, TOL_E2E_DEEP = 2e-5, 5e-4, 2e-2
TOL_CLF = 1e-4                   # classifier, card against CPU


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Time per call of ``fn`` over ``iters`` back-to-back calls, between
    CUDA events: where the host launches slower than the device runs, this
    is the host's launch rate, not the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls are captured into one
    CUDA graph and the graph is replayed between CUDA events, so the
    host's launch time is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 10, 2) / iters


def host_us(fn, iters: int = 1000) -> float:
    """Host time per call of ``fn`` in microseconds: the host clock over
    ``iters`` back-to-back calls, without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return host


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref) -> float:
    """Largest over rows (last axis) of max|out - ref| / max|ref|."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


def ptxas_instances(log: str, pattern: str) -> list:
    """Each kernel in ptxas's report whose name matches ``pattern`` (two
    groups: its type and its head-dim class): registers and spill bytes
    (stores, loads)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(pattern, m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(dict(dtype="float32" if name.group(1) == "f"
                            else "bfloat16", hdp=int(name.group(2)),
                            registers=int(m.group(1)), spill_bytes=spill))
            name = None
    return out


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per (batch, head)."""
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def device_busy(fn, trace_path: Path) -> dict:
    """Run ``fn`` once under the profiler; the device's busy time is the
    union of the kernel and copy intervals inside the call's span."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("wave"):
            fn()
            torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    span = [e for e in events if e.get("ph") == "X" and e.get("name") ==
            "wave" and e.get("cat") == "user_annotation"]
    check(len(span) == 1, f"{len(span)} 'wave' spans in the trace")
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    work = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, by_name, flash = 0.0, lo, {}, 0.0
    for a, b, name in work:
        if b > a:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a)
            flash += (b - a) if "flash_fwd" in name else 0.0
    check(busy > 0, "the profiler trace holds no device work")
    traced_wall = (hi - lo) * 1e-6
    return {"kernels": len(work), "traced_wall_s": traced_wall,
            "device_busy_s": busy * 1e-6,
            "device_idle_share": 1 - busy * 1e-6 / traced_wall,
            "flash_attention_device_s": flash * 1e-6,
            "flash_attention_share_of_busy": flash / busy,
            "top_device_us": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:10]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.oscar import DataConfig, DiffusionConfig
    from repro_torch.core.oscar import client_encodings, synthesize
    from repro_torch.data.federated import make_federated_data
    from repro_torch.diffusion import guidance as guid
    from repro_torch.diffusion.dit import DiT
    from repro_torch.diffusion.sampler import (sample_cfg, sample_cfg_ragged,
                                               sample_cfg_window, sample_mixed)
    from repro_torch.diffusion.schedule import make_schedule
    from repro_torch.encoders.foundation import FrozenFM
    from repro_torch.kernels.adaln_norm import kernel as an_kernel
    from repro_torch.kernels.adaln_norm import ops as an_ops
    from repro_torch.kernels.adaln_norm import ref as an_ref
    from repro_torch.kernels.build import (BUILD_DIR, EMPTY_SOURCE,
                                           build_log, check_cuda_inputs,
                                           compile_all, empty_launch)
    from repro_torch.kernels.cfg_fuse import kernel as cfg_kernel
    from repro_torch.kernels.cfg_fuse import ops as cfg_ops
    from repro_torch.kernels.cfg_fuse import ref as cfg_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.models.classifiers import (classifier_logprob,
                                                init_classifier)
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_serve_step
    from repro_torch.serve import synthesis as serve_synthesis
    from repro_torch.serve.synthesis import SynthesisEngine
    from repro_torch.utils import default_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = default_device()
    say(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # phase 2's checks past its first few (the short kernel's modes, bf16
    # and odd widths of adaln_norm, 8a's fp32 layer) draw from a generator
    # of their own, so that the later phases draw the same data whatever
    # phase 2 checks: the 4-step ragged gate of phase 6 amplifies a 1e-6
    # difference by ~2e4 (1 + 2s) in the few values the first step leaves
    # unclipped, and on other seeded weights plain against plain at another
    # batch size exceeds it
    g16 = torch.Generator(dev).manual_seed(16)

    def randn16(*shape):
        return torch.randn(shape, generator=g16, device=dev)

    # -- 1. build ------------------------------------------------------------
    # one nvcc per CUDA source, all started together
    sources = (fa_kernel.SOURCE, fa_kernel.TC_SOURCE, fa_kernel.SHORT_SOURCE,
               an_kernel.SOURCE, rn_kernel.SOURCE, cfg_kernel.SOURCE,
               EMPTY_SOURCE)
    t0 = time.perf_counter()
    nvcc_s = compile_all(sources)
    t_nvcc = time.perf_counter() - t0
    fa_kernel.build()
    fa_kernel.build_tc()
    fa_kernel.build_short()
    an_kernel.build()
    rn_kernel.build()
    cfg_kernel.build()
    for src in sources:
        log = build_log(src)
        if src in (fa_kernel.TC_SOURCE, cfg_kernel.SOURCE, EMPTY_SOURCE):
            for line in log.splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling",
                                           "arning", "Performance Loss")):
                    say(f"[1] ptxas {src.name}: {line.strip()}")
            continue
        # one line a template instance: the summary, and any spill or warning
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [(int(a), int(b)) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        say(f"[1] ptxas {src.name}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)}, spill bytes (stores, loads) at most "
            f"{max(spills)}")
        for line in log.splitlines():
            if "arning" in line or "Performance Loss" in line:
                say(f"[1] ptxas {src.name}: {line.strip()}")
    tc_log = build_log(fa_kernel.TC_SOURCE)
    tc_spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", tc_log)
    check(len(tc_spills) == 4 and all(a == b == "0" for a, b in tc_spills),
          f"flash_attention_tc spills: {tc_spills}")
    check("Performance Loss" not in tc_log, "ptxas serialised the wgmma "
          "instructions of flash_attention_tc")
    cfg_spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", build_log(cfg_kernel.SOURCE))
    # the six instances: scalar, rowwise and mixed, z from memory and keyed
    check(len(cfg_spills) == 6 and all(a == b == "0" for a, b in cfg_spills),
          f"cfg_fuse.cu spills: {cfg_spills}")
    cc_instances = ptxas_instances(build_log(fa_kernel.SOURCE),
                                   r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E")
    check(len(cc_instances) == 2 * len(fa_kernel.CUDA_CORE_TILES)
          and all(i["spill_bytes"] == (0, 0) for i in cc_instances),
          f"flash_attention.cu instances or spills: {cc_instances}")
    t0 = time.perf_counter()
    small = randn(2, 4, 8)
    an_ops.adaln_norm(small, randn(2, 8), randn(2, 8))
    cfg_ops.cfg_update(small, small, small, 2.0, 0.5, 0.7, small)
    one = np.ones(2, np.float32)
    cfg_ops.cfg_update_rowwise(small, small, small, one, 0.5 * one, 0.7 * one,
                               small, one)
    cfg_ops.cfg_update_mixed(small, small, small, one, one, 0.5 * one,
                             0.7 * one, small, one)
    rn_ops.rmsnorm(small, randn(8))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    say(f"[1] build: nvcc {t_nvcc:.2f} s for all seven sources together ("
        + ", ".join(f"{src.name} {sec:.2f} s" for src, sec in nvcc_s.items())
        + f"; flash_attention_tc 4 instances, flash_attention "
        f"{len(cc_instances)} and cfg_fuse {len(cfg_spills)}, 0 spill "
        f"bytes), first launches of adaln_norm, rmsnorm, cfg_update, "
        f"cfg_update_rowwise and cfg_update_mixed {t_first:.2f} s")

    # -- 2. kernels against their plain versions -----------------------------
    kernels = {}

    def record(name, route, source, replaces, tol, checks, launch,
               plain, library, nbytes, flops, shape, peak=FP32_FLOPS,
               iters=100, phase=2, int_ops=0, **extra):
        """One row of the kernels line; device times, the library call's
        too, are graph replays.  The bound is the larger of the bytes over
        the memory rate and ``flops`` at ``peak``; the say line splits it
        into bytes, operations and (``int_ops``, an estimate at
        ``INT32_OPS``) int32 operations."""
        err = max(c["max_abs_err"] for c in checks)
        check(err <= tol, f"{name}: max abs error {err:.3g} > {tol:g}")
        b_ms, b_by = bound(nbytes, flops, peak)
        split = (f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, operations "
                 f"{flops / peak * 1e3:.5f} ms"
                 + (f", int32 operations (estimate) "
                    f"{int_ops / INT32_OPS * 1e3:.5f} ms" if int_ops
                    else ""))
        lib_dev = (None if library is None
                   else graph_ms(library, max(2, iters // 5)))
        kernels[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=None, max_abs_err=err, tol=tol,
            ms=cuda_ms(launch, iters), plain_ms=cuda_ms(plain, iters),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else cuda_ms(library, iters),
            device_ms=graph_ms(launch, max(2, iters // 5)),
            library_device_ms=lib_dev, shape=shape, checks=checks, **extra)
        k = kernels[name]
        say(f"[{phase}] {name}: max_abs_err {err:.3g} (tol {tol:g}) over "
            f"{len(checks)} checks; at {shape}: {k['ms']:.4f} ms per call, "
            f"{k['device_ms']:.4f} ms on the device, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms per call "
            f"and {lib_dev} ms on the device, bound {b_ms:.4f} ms ({b_by}; "
            f"{split}), "
            f"launch floor {extra.get('launch_floor_ms')} ms, memory phases "
            f"alone {extra.get('memory_only_ms')} ms ({smi})")

    # cfg_fuse.cu's two kernels in both noise modes.  The checks that the
    # rows had before this source draw from `g` in their old order, so the
    # later phases see the same data; the new ones draw from a generator
    # of their own.  Each check is bit-equal (tol TOL_CFG, expected 0) to
    # the plain version: z from memory against ref, z drawn from keys
    # against prng.normal of the same keys and then ref
    g18 = torch.Generator(dev).manual_seed(18)

    def randn18(*shape):
        return torch.randn(shape, generator=g18, device=dev)

    def offset_view(*shape):        # contiguous, 4 bytes off alignment
        return randn18(math.prod(shape) + 1)[1:].view(shape)

    def cfg_binding(wrapper, binding, checks_of, out, args, keyed_args):
        """What a call costs on the host: the whole wrapper, the binding
        alone, and its parts (the input checks, the output's allocation,
        the packed arguments, the ctypes call timed on a block the library
        refuses before launching)."""
        return dict(
            wrapper=host_us(wrapper), binding=host_us(binding),
            input_checks=host_us(checks_of),
            output_alloc=host_us(lambda: torch.empty_like(out)),
            pack_arguments=host_us(args),
            ctypes_packed=host_us(lambda: cfg_lib.cfg_fuse_fwd(cfg_bad, 0)),
            keyed=keyed_args)

    cfg_lib = cfg_kernel._lib()
    cfg_bad = cfg_kernel._ARGS.pack(*[0] * 18, *[0.0] * 8, 0, 0)

    def geometry_of(args):
        a = cfg_kernel._ARGS.unpack(args)
        return dict(vector_route=bool(a[14]), blocks=a[15], threads=a[16])

    def floor_of(args, x):
        """The launch floor of the update launched with ``args``: an empty
        kernel at its grid and block, replayed in a graph."""
        geo = geometry_of(args)
        return graph_ms(lambda: empty_launch(
            (geo["blocks"], 1), geo["threads"], 0, x.get_device()))

    key2 = prng.split(prng.PRNGKey(18))[1]
    key2_words = tuple(int(w) for w in key2)

    # cfg_update: a wave's 128 x 16 x 16 x 3, a 120-row wave's, an odd total
    # size and a view 4 bytes off alignment (one element at a time), at the
    # first step of a 4-step (t = 999) and of a 50-step trajectory and at
    # the last (t = 0) step, where the keyed mode's z is 0
    sched = make_schedule(1000, device=dev)
    ab = sched.alpha_bar
    steps = [(float(ab[999]), float(ab[666])), (float(ab[999]), float(ab[979]))]
    last = (float(ab[0]), 1.0)
    checks, keyed_checks = [], []

    def cfg_pair(x, ec, eu, z, abt, abp, live, what):
        out = cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, z)
        ref = cfg_ref.cfg_update(x, ec, eu, 2.0, abt, abp, z)
        checks.append(dict(what, ab_t=abt, ab_prev=abp,
                           max_abs_err=max_err(out, ref)))
        out = cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, None,
                                 noise_key=key2_words, live=live)
        ref = cfg_ref.cfg_update_keyed(x, ec, eu, 2.0, abt, abp, key2, live)
        keyed_checks.append(dict(what, ab_t=abt, ab_prev=abp, live=live,
                                 max_abs_err=max_err(out, ref)))

    for shape in [(128, 16, 16, 3), (3, 5, 7)]:
        x, ec, eu, z = (randn(*shape) for _ in range(4))
        for abt, abp in steps:
            cfg_pair(x, ec, eu, z, abt, abp, True, dict(shape=list(shape)))
        cfg_pair(x, ec, eu, torch.zeros_like(x), *last, False,
                 dict(shape=list(shape)))
    for shape, view in (((120, 16, 16, 3), randn18),
                        ((120, 16, 16, 3), offset_view),
                        ((128, 16, 16, 3), offset_view)):
        x, ec, eu, z = (view(*shape) for _ in range(4))
        what = dict(shape=list(shape), vector_route=cfg_kernel.vector_route(
            x.numel(), [t.data_ptr() for t in (x, ec, eu, z)], False))
        for abt, abp in steps:
            cfg_pair(x, ec, eu, z, abt, abp, True, what)
        cfg_pair(x, ec, eu, torch.zeros_like(x), *last, False, what)
    check(sum(c.get("vector_route", True) for c in checks) == len(checks) - 6,
          "cfg_update: unexpected routes")
    x, ec, eu, z = (randn(128, 16, 16, 3) for _ in range(4))
    abt, abp = steps[1]
    n = x.numel()
    # the sampler's call: this step's scalars, from the cache after a wave
    row_sc = cfg_ops.step_scalars(2.0, abt, abp, 1.0)
    cfg_out = torch.empty_like(x)
    sc8 = (*row_sc, 1.0)
    z_args = cfg_kernel._args(x, ec, eu, z, cfg_out, rows=1, scalars=sc8)
    k_args = cfg_kernel._args(x, ec, eu, None, cfg_out, rows=1, scalars=sc8,
                              key=key2_words)
    # the keyed mode's draw, per element, counted from the source and not
    # measured: ~75 int32 operations (20 threefry rounds of add, rotate and
    # xor; the key injections; the counter and the uniform's shift and or)
    # and ~45 fp32 ones (log1pf ~16, the erfinv polynomial's 16, the
    # uniform and the scaling)
    draw_int, draw_fp = 75, 45
    binding = cfg_binding(
        lambda: cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, z),
        lambda: cfg_kernel.cfg_update_flat(x, ec, eu, z, row_sc),
        lambda: cfg_ops._check_update_inputs("cfg_update", x, ec, eu, z),
        x, lambda: cfg_kernel._args(x, ec, eu, z, cfg_out, rows=1,
                                    scalars=sc8),
        dict(wrapper=host_us(lambda: cfg_ops.cfg_update(
            x, ec, eu, 2.0, abt, abp, None, noise_key=key2_words)),
             step_scalars_cached=host_us(lambda: cfg_ops.step_scalars(
                 2.0, abt, abp, 1.0)),
             step_scalars_uncached=host_us(
                 lambda: cfg_ops.step_scalars.__wrapped__(2.0, abt, abp,
                                                          1.0))))
    say(f"[2] cfg_update binding, host us per call ({smi}): "
        f"{json.dumps(binding)}")
    record("cfg_update", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:155", TOL_CFG, checks,
           lambda: cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, z),
           lambda: cfg_ref.cfg_update(x, ec, eu, 2.0, abt, abp, z), None,
           5 * 4 * n, 13 * n, [128, 16, 16, 3], mode="z from memory",
           launch_floor_ms=floor_of(z_args, x),
           host_us_breakdown=binding, geometry=geometry_of(z_args))
    record("cfg_update_keyed", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:155", TOL_CFG, keyed_checks,
           lambda: cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, None,
                                      noise_key=key2_words),
           lambda: cfg_ref.cfg_update_keyed(x, ec, eu, 2.0, abt, abp, key2,
                                            True), None,
           4 * 4 * n, (13 + draw_fp) * n, [128, 16, 16, 3],
           int_ops=draw_int * n, mode="z drawn from the step's threefry key",
           launch_floor_ms=floor_of(k_args, x),
           host_us_breakdown=binding["keyed"], geometry=geometry_of(k_args))

    # cfg_update_rowwise: a 120-row ragged wave, (120, 16, 16, 3), rows in
    # turn at the t = 999 first step of a 4-step trajectory, the first step
    # of a 50-step one, a mid step and frozen; then windows at row_offset 0,
    # 120 and 37 of a wider (240-slot) table, a 128-row wave and odd rows
    # (5 x 7 elements, one at a time); then the refusal of a window that
    # leaves the table.  The keyed mode draws each row's z from its own key
    # times its live entry, 0 for every fifth row (a row at its t = 0 step)
    def rowwise_table(Bs):
        rows = [(2.0, steps[0][0], steps[0][1], 1.0),
                (7.5, steps[1][0], steps[1][1], 1.0),
                (1.5, float(ab[500]), float(ab[480]), 1.0),
                (4.0, float(ab[999]), float(ab[979]), 0.0)]
        return [np.array(c, np.float32)
                for c in zip(*(rows[i % 4] for i in range(Bs)))]

    def plain_rowwise(x, ec, eu, dvecs, z, off):
        s_, t_, p_, a_ = dvecs       # the same scalars, on the card
        return cfg_ref.cfg_update_rowwise_windowed(x, ec, eu, s_, t_, p_, z,
                                                   a_, row_offset=off)

    def on_card(vecs):
        return [torch.as_tensor(v, device=dev) for v in vecs]

    def row_keys_of(B):
        keys = prng.split(prng.PRNGKey(19), B)
        live = torch.as_tensor(np.arange(B) % 5 != 4, device=dev).float()
        return keys, cfg_ops.key_table(keys, dev), live

    checks, keyed_checks = [], []

    def rowwise_pair(x, ec, eu, z, vecs, off):
        B = x.shape[0]
        out = cfg_ops.cfg_update_rowwise(x, ec, eu, *vecs[:3], z, vecs[3],
                                         row_offset=off)
        ref = plain_rowwise(x, ec, eu, on_card(vecs), z, off)
        frozen = torch.as_tensor(vecs[3][off:off + B] == 0, device=dev)
        check(torch.equal(out[frozen], x[frozen]),
              "cfg_update_rowwise changed a frozen row")
        what = dict(shape=list(x.shape), slots=len(vecs[0]), row_offset=off)
        checks.append(dict(what, max_abs_err=max_err(out, ref)))
        keys, dkeys, live = row_keys_of(B)
        out = cfg_ops.cfg_update_rowwise(x, ec, eu, *vecs[:3], None, vecs[3],
                                         row_offset=off, noise_keys=dkeys,
                                         live=live)
        ref = plain_rowwise(x, ec, eu, on_card(vecs), cfg_ref.row_noise(
            keys, live, x.shape[1:], dev), off)
        check(torch.equal(out[frozen], x[frozen]),
              "keyed cfg_update_rowwise changed a frozen row")
        keyed_checks.append(dict(what, max_abs_err=max_err(out, ref)))

    for B, Bs, off in [(120, 120, 0), (120, 240, 0), (120, 240, 120),
                       (60, 240, 37)]:
        vecs = rowwise_table(Bs)
        x, ec, eu, z = (randn(B, 16, 16, 3) for _ in range(4))
        rowwise_pair(x, ec, eu, z, vecs, off)
    for B, Bs, off, row in [(128, 128, 0, (16, 16, 3)), (3, 9, 0, (5, 7)),
                            (5, 9, 3, (5, 7))]:
        rowwise_pair(*(randn18(B, *row) for _ in range(4)),
                     rowwise_table(Bs), off)
    for bad in (-1, len(vecs[0]) - x.shape[0] + 1):
        try:
            cfg_ops.cfg_update_rowwise(x, ec, eu, *vecs[:3], z, vecs[3],
                                       row_offset=bad)
        except ValueError:
            continue
        check(False, f"cfg_update_rowwise took row_offset {bad} of "
              f"{len(vecs[0])} slots for {x.shape[0]} rows")
    vecs = rowwise_table(120)
    x, ec, eu, z = (randn(120, 16, 16, 3) for _ in range(4))
    table = torch.as_tensor(cfg_ops.rowwise_coeffs(*vecs, 1.0), device=dev)
    dvecs = on_card(vecs)
    keys, dkeys, live = row_keys_of(120)
    n = x.numel()
    rw_out = torch.empty_like(x)
    rz_args = cfg_kernel._args(x, ec, eu, z, rw_out, rows=120, coeffs=table)
    rk_args = cfg_kernel._args(x, ec, eu, None, rw_out, rows=120,
                               coeffs=table, keys=dkeys, live=live)
    binding = cfg_binding(
        lambda: cfg_ops.cfg_update_rowwise(x, ec, eu, *vecs[:3], z, vecs[3],
                                           coeffs=table),
        lambda: cfg_kernel.cfg_update_rowwise_flat(x, ec, eu, z, table, 0),
        lambda: cfg_ops._check_update_inputs("cfg_update_rowwise", x, ec, eu,
                                             z),
        x, lambda: cfg_kernel._args(x, ec, eu, z, rw_out, rows=120,
                                    coeffs=table),
        dict(wrapper=host_us(lambda: cfg_ops.cfg_update_rowwise(
            x, ec, eu, *vecs[:3], None, vecs[3], coeffs=table,
            noise_keys=dkeys, live=live))))
    say(f"[2] cfg_update_rowwise binding, host us per call ({smi}): "
        f"{json.dumps(binding)}")
    # 3 in 4 rows are active; a frozen row is read once and written once
    act_n = n * int((vecs[3] > 0).sum()) // 120
    record("cfg_update_rowwise", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:120", TOL_CFG, checks,
           lambda: cfg_ops.cfg_update_rowwise(x, ec, eu, *vecs[:3], z,
                                              vecs[3], coeffs=table),
           lambda: plain_rowwise(x, ec, eu, dvecs, z, 0), None,
           5 * 4 * act_n + 8 * (n - act_n) + 4 * table.numel(), 13 * act_n,
           [120, 16, 16, 3], mode="z from memory",
           launch_floor_ms=floor_of(rz_args, x),
           host_us_breakdown=binding, geometry=geometry_of(rz_args))
    record("cfg_update_rowwise_keyed", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:120", TOL_CFG, keyed_checks,
           lambda: cfg_ops.cfg_update_rowwise(
               x, ec, eu, *vecs[:3], None, vecs[3], coeffs=table,
               noise_keys=dkeys, live=live),
           lambda: plain_rowwise(x, ec, eu, dvecs, cfg_ref.row_noise(
               keys, live, (16, 16, 3), dev), 0), None,
           4 * 4 * act_n + 8 * (n - act_n) + 4 * table.numel() + 12 * 120,
           (13 + draw_fp) * act_n, [120, 16, 16, 3], int_ops=draw_int * act_n,
           mode="z drawn from each row's threefry key",
           launch_floor_ms=floor_of(rk_args, x),
           host_us_breakdown=binding["keyed"],
           geometry=geometry_of(rk_args))

    # cfg_update_mixed: the same tables with a mode row, all 0 (bit-equal
    # to cfg_update_rowwise in the same noise mode), all 1, and mixed over
    # the inactive rows, in both noise modes; the windows draw x, ε_c, ε_u
    # and z from `g` in their old order, the 128-row wave and odd rows from
    # g18 (one element a thread); then the refusal of a window that leaves
    # the table, in both modes
    def mode_row(kind, Bs):
        i = np.arange(Bs)
        return {"cfg": 0 * i, "clf": 0 * i + 1,
                "mixed": (i % 3 == 1) * 1}[kind].astype(np.float32)

    def mixed_pair(x, ec, eu, z, vecs, off):
        B, Bs = x.shape[0], len(vecs[0])
        s_, t_, p_, a_ = on_card(vecs)
        keys, dkeys, live = row_keys_of(B)
        frozen = torch.as_tensor(vecs[3][off:off + B] == 0, device=dev)
        sources = (("", z, {}, z, checks),
                   ("keyed ", None, dict(noise_keys=dkeys, live=live),
                    cfg_ref.row_noise(keys, live, x.shape[1:], dev),
                    keyed_checks))
        for kind in ("cfg", "clf", "mixed"):
            mode = mode_row(kind, Bs)
            dmode = on_card([mode])[0]
            for label, noise, zk, plain_z, into in sources:
                out = cfg_ops.cfg_update_mixed(x, ec, eu, mode, *vecs[:3],
                                               noise, vecs[3],
                                               row_offset=off, **zk)
                ref = cfg_ref.cfg_update_mixed_windowed(
                    x, ec, eu, dmode, s_, t_, p_, plain_z, a_, row_offset=off)
                check(torch.equal(out[frozen], x[frozen]),
                      f"{label}cfg_update_mixed changed a frozen row")
                if kind == "cfg":
                    check(torch.equal(out, cfg_ops.cfg_update_rowwise(
                        x, ec, eu, *vecs[:3], noise, vecs[3], row_offset=off,
                        **zk)), f"all-mode-0 {label}cfg_update_mixed is not "
                        f"bit-equal to {label}cfg_update_rowwise")
                into.append(dict(shape=list(x.shape), slots=Bs,
                                 row_offset=off, modes=kind,
                                 max_abs_err=max_err(out, ref)))
        for bad in (-1, Bs - B + 1):
            for label, noise, zk, _, _ in sources:
                try:
                    cfg_ops.cfg_update_mixed(x, ec, eu, mode, *vecs[:3], noise,
                                             vecs[3], row_offset=bad, **zk)
                except ValueError:
                    continue
                check(False, f"{label}cfg_update_mixed took row_offset {bad} "
                      f"of {Bs} slots for {B} rows")

    checks, keyed_checks = [], []
    for B, Bs, off in [(120, 120, 0), (120, 240, 0), (120, 240, 120),
                       (60, 240, 37)]:
        vecs = rowwise_table(Bs)
        x, ec, eu, z = (randn(B, 16, 16, 3) for _ in range(4))
        mixed_pair(x, ec, eu, z, vecs, off)
    for B, Bs, off, row in [(128, 128, 0, (16, 16, 3)), (3, 9, 0, (5, 7)),
                            (5, 9, 3, (5, 7))]:
        mixed_pair(*(randn18(B, *row) for _ in range(4)),
                   rowwise_table(Bs), off)
    vecs = rowwise_table(120)
    mode = mode_row("mixed", 120)
    x, ec, eu, z = (randn(120, 16, 16, 3) for _ in range(4))
    table = torch.as_tensor(cfg_ops.mixed_coeffs(mode, *vecs, 1.0),
                            device=dev)
    dvecs, dmode = on_card(vecs), on_card([mode])[0]
    keys, dkeys, live = row_keys_of(120)
    n = x.numel()
    mx_out = torch.empty_like(x)
    mz_args = cfg_kernel._args(x, ec, eu, z, mx_out, rows=120, coeffs=table,
                               mixed=True)
    mk_args = cfg_kernel._args(x, ec, eu, None, mx_out, rows=120,
                               coeffs=table, mixed=True, keys=dkeys,
                               live=live)
    binding = cfg_binding(
        lambda: cfg_ops.cfg_update_mixed(x, ec, eu, mode, *vecs[:3], z,
                                         vecs[3], coeffs=table),
        lambda: cfg_kernel.cfg_update_mixed_flat(x, ec, eu, z, table, 0),
        lambda: cfg_ops._check_update_inputs("cfg_update_mixed", x, ec, eu,
                                             z),
        x, lambda: cfg_kernel._args(x, ec, eu, z, mx_out, rows=120,
                                    coeffs=table, mixed=True),
        dict(wrapper=host_us(lambda: cfg_ops.cfg_update_mixed(
            x, ec, eu, mode, *vecs[:3], None, vecs[3], coeffs=table,
            noise_keys=dkeys, live=live))))
    say(f"[2] cfg_update_mixed binding, host us per call ({smi}): "
        f"{json.dumps(binding)}")
    # what the data needs: an active classifier-free row reads x, ε_c, ε_u
    # and z and writes out (13 operations an element), an active
    # classifier-guided row no ε_u (10 operations: no combine), a frozen
    # row is read once and written once; keyed, no z but each row's key
    # and live entry.  90 of the 120 rows are active, 30 of them guided
    active = vecs[3] > 0
    n_cfg = n * int((active & (mode < 0.5)).sum()) // 120
    n_clf = n * int((active & (mode >= 0.5)).sum()) // 120
    n_frozen = n - n_cfg - n_clf
    record("cfg_update_mixed", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:94", TOL_CFG, checks,
           lambda: cfg_ops.cfg_update_mixed(x, ec, eu, mode, *vecs[:3], z,
                                            vecs[3], coeffs=table),
           lambda: cfg_ref.cfg_update_mixed(x, ec, eu, dmode, *dvecs[:3], z,
                                            dvecs[3]), None,
           20 * n_cfg + 16 * n_clf + 8 * n_frozen + 4 * table.numel(),
           13 * n_cfg + 10 * n_clf, [120, 16, 16, 3], mode="z from memory",
           launch_floor_ms=floor_of(mz_args, x), host_us_breakdown=binding,
           geometry=geometry_of(mz_args))
    record("cfg_update_mixed_keyed", "cuda",
           "src/repro_torch/kernels/cfg_fuse/csrc/cfg_fuse.cu",
           "src/repro/kernels/cfg_fuse/kernel.py:94", TOL_CFG, keyed_checks,
           lambda: cfg_ops.cfg_update_mixed(
               x, ec, eu, mode, *vecs[:3], None, vecs[3], coeffs=table,
               noise_keys=dkeys, live=live),
           lambda: cfg_ref.cfg_update_mixed(
               x, ec, eu, dmode, *dvecs[:3], cfg_ref.row_noise(
                   keys, live, (16, 16, 3), dev), dvecs[3]), None,
           16 * n_cfg + 12 * n_clf + 8 * n_frozen + 4 * table.numel()
           + 12 * 120, (13 + draw_fp) * n_cfg + (10 + draw_fp) * n_clf,
           [120, 16, 16, 3], int_ops=draw_int * (n_cfg + n_clf),
           mode="z drawn from each row's threefry key",
           launch_floor_ms=floor_of(mk_args, x),
           host_us_breakdown=binding["keyed"], geometry=geometry_of(mk_args))

    # adaln_norm: the block sites (B, S, d), the final site (the strided
    # tok[:, 1:] view), the default d_model and an odd d (one element at a
    # time), fp32 and bf16; scale/shift are strided chunks of a (B, 6d)
    # modulation, as in the DiT.  bf16 is held against the plain version in
    # fp32 on the same bf16 inputs, within one bf16 ulp of each element plus
    # the fp32 gate
    def adaln_inputs(B, N, d, drop_first, dt=torch.float32, rand=randn):
        xx = rand(B, N + drop_first, d).to(dt)[:, drop_first:]
        mod = rand(B, 6 * d).to(dt)
        return xx, mod[:, d:2 * d], mod[:, :d]

    checks, bf16_checks = [], []
    for B, N, d, drop in [(256, 17, 144, 0), (256, 16, 144, 1),
                          (256, 17, 128, 0), (64, 17, 145, 0),
                          (3, 40, 2048, 1)]:
        xs = adaln_inputs(B, N, d, drop,
                          rand=randn if d in (128, 144) else randn16)
        out = an_ops.adaln_norm(*xs)
        check(torch.equal(out, an_ops.adaln_norm(*xs)),
              f"adaln_norm {B, N, d}: two calls differ")
        checks.append(dict(shape=[B, N, d],
                           vector_route=an_kernel.vector_route(xs[0]),
                           max_abs_err=max_err(out, an_ref.adaln_norm(*xs))))
        xs = adaln_inputs(B, N, d, drop, torch.bfloat16, randn16)
        ref = an_ref.adaln_norm(*(t.float() for t in xs))
        diff = (an_ops.adaln_norm(*xs).float() - ref).abs()
        over = int((diff > TOL_ADALN_BF16_ULP * ref.abs() + TOL_ADALN).sum())
        check(over == 0, f"adaln_norm {B, N, d} bf16: {over} elements more "
              f"than one bf16 ulp + {TOL_ADALN:g} from the plain version")
        bf16_checks.append(dict(shape=[B, N, d],
                                vector_route=an_kernel.vector_route(xs[0]),
                                max_abs_err=float(diff.max())))
    check([c["vector_route"] for c in checks]
          == [True, True, True, False, True], "adaln_norm: unexpected routes")
    xs = adaln_inputs(256, 17, 144, 0)
    elems = 256 * 17 * 144
    geo = an_kernel.geometry(256, 17, 144, True, 4)
    # what a call costs on the host: the whole wrapper, the binding alone,
    # and the binding's parts (the input checks, the output's allocation,
    # the packed geometry, the ctypes call timed on a geometry the library
    # rejects before launching)
    an_lib, an_bad = an_kernel._lib(), an_kernel._ARGS.pack(*[0] * 14)
    an_ptrs = [t.data_ptr() for t in xs] + [xs[0].data_ptr()]
    an_binding = dict(
        wrapper=host_us(lambda: an_ops.adaln_norm(*xs)),
        binding=host_us(lambda: an_kernel.adaln_norm_3d(*xs, 1e-6)),
        input_checks=host_us(lambda: check_cuda_inputs("adaln_norm", *xs)),
        output_alloc=host_us(lambda: torch.empty_like(
            xs[0], memory_format=torch.contiguous_format)),
        pack_geometry=host_us(lambda: an_kernel._args(*xs, an_ptrs[0])),
        ctypes_packed=host_us(lambda: an_lib.adaln_norm_fwd(
            *an_ptrs, an_bad, 1e-6, 0)))
    say(f"[2] adaln_norm binding, host us per call ({smi}): "
        f"{json.dumps(an_binding)}")
    record("adaln_norm", "cuda",
           "src/repro_torch/kernels/adaln_norm/csrc/adaln_norm.cu",
           "src/repro/kernels/adaln_norm/kernel.py:33", TOL_ADALN, checks,
           lambda: an_ops.adaln_norm(*xs), lambda: an_ref.adaln_norm(*xs),
           None, 4 * (2 * elems + 2 * 256 * 144), 8 * elems, [256, 17, 144],
           bf16_checks=bf16_checks,
           launch_floor_ms=graph_ms(lambda: an_kernel.empty_launch(*xs)),
           host_us_breakdown=an_binding,
           geometry=dict(values_per_lane=geo[0], warps_per_block=geo[1],
                         batch_rows_per_block=geo[2], blocks=geo[3],
                         shared_bytes=geo[4]))

    # flash_attention: q, k, v as views of a (B, S, 3, H, hd) QKV buffer
    def qkv_views(B, S, H, hd, dt=torch.float32):
        qkv = randn(B, S, 3, H, hd).to(dt)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def plain_attn(q, k, v, causal=False, **kw):
        return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                **kw).transpose(1, 2)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    fa = fa_ops.flash_attention

    def attn_check(q, k, v, route, **kw):
        """One call against the plain version, on the route named."""
        kw.setdefault("causal", False)
        n0 = (fa.launches_short, fa.launches_tensor_core,
              fa.launches_cuda_core)
        out = fa(q, k, v, **kw)
        moved = (fa.launches_short - n0[0], fa.launches_tensor_core - n0[1],
                 fa.launches_cuda_core - n0[2])
        want = {"short": (1, 0, 0), "tensor_core": (0, 1, 0),
                "cuda_core": (0, 0, 1)}[route]
        check(moved == want, f"flash_attention {tuple(q.shape)} "
              f"{q.dtype} {kw}: routes {moved}, want {route}")
        ref = plain_attn(q, k, v, **kw)
        err, rel = max_err(out, ref), row_rel_err(out, ref)
        if q.dtype == torch.float32:
            check(err <= TOL_ATTN, f"flash_attention {tuple(q.shape)} {kw}: "
                  f"max abs error {err:.3g}")
        else:
            check(err <= TOL_ATTN_BF16 and rel <= TOL_ATTN_BF16_ROW,
                  f"flash_attention {tuple(q.shape)} bf16 {kw}: max abs "
                  f"error {err:.3g}, row-relative {rel:.3g}")
        return dict(shape=list(q.shape) + [k.shape[2]], dtype=str(q.dtype)[6:],
                    **kw, max_abs_err=err, max_row_rel_err=rel)

    # the short kernel: the DiT's calls (QKV views, hd 36 and the default
    # 32), then every mode at S = 1, 17 and 32, head dims 20, 36 and 64,
    # GQA 4/2 and MQA 4/1, fp32 and bf16, and views 4 bytes off 16-byte
    # alignment (read one element at a time, as bf16 at hd 20 is); the
    # cap's knee with q x 10 (v at half scale: near one-hot rows in bf16)
    short_checks = [attn_check(*qkv_views(256, 17, 4, hd), "short")
                    for hd in (36, 32)]
    long_qkv = qkv_views(4, 3137, 4, 32)        # the CUDA-core check's
    q, k, v = qkv_views(256, 17, 4, 36)         # the timed call
    for dt in (torch.float32, torch.bfloat16):
        for S, hd, hkv, off in ((1, 36, 4, 0), (17, 36, 2, 0),
                                (32, 64, 1, 0), (17, 20, 4, 0),
                                (17, 36, 4, 2)):
            qq, kk, vv = (randn16(8, S, h, hd + off)[..., off:]
                          for h in (4, hkv, hkv))
            for kw in (dict(causal=False), dict(causal=True),
                       dict(causal=True, window=5),
                       dict(causal=False, softcap=50.0)):
                sharp = 10.0 if kw.get("softcap") else 1.0
                short_checks.append(attn_check(
                    (qq * sharp).to(dt), kk.to(dt),
                    (vv * (0.5 if sharp > 1 else 1.0)).to(dt), "short",
                    **kw))
    fp32_short = [c for c in short_checks if c["dtype"] == "float32"]
    bf16_short = [c for c in short_checks if c["dtype"] == "bfloat16"]
    check(torch.equal(fa(q, k, v, causal=False), fa(q, k, v, causal=False)),
          "flash_attention_short: two calls differ")
    check(fa_kernel.vector_loads(q), "the DiT's QKV views are not read 16 "
          "bytes at a time")
    hb, nkv, smem = fa_kernel.short_geometry(4, 4, 17, 17, 36)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = 256 * -(-4 // hb)
    cuda_core_same_call = dict(  # the kernel the DiT's call took before
        ms=cuda_ms(lambda: fa_kernel.flash_attention_bshd(
            q, k, v, causal=False, window=0, softcap=0.0)),
        device_ms=graph_ms(lambda: fa_kernel.flash_attention_bshd(
            q, k, v, causal=False, window=0, softcap=0.0)),
        max_abs_err=max_err(fa_kernel.flash_attention_bshd(
            q, k, v, causal=False, window=0, softcap=0.0), plain_attn(q, k, v)))
    # what a call costs on the host, piece by piece: the whole wrapper, the
    # short and the CUDA-core bindings alone, and their parts (the packed
    # geometry, the ctypes call timed on a geometry the library rejects
    # before launching)
    ptrs = [t.data_ptr() for t in (q, k, v, q)]
    cc_lib, short_lib = fa_kernel._lib(), fa_kernel._short_lib()
    bad_short = fa_kernel._SHORT_ARGS.pack(*[0] * 25)
    bad_cc = fa_kernel._CC_ARGS.pack(*[0] * 26)
    binding = dict(
        wrapper=host_us(lambda: fa(q, k, v, causal=False)),
        short_binding=host_us(lambda: fa_kernel.flash_attention_short_bshd(
            q, k, v, causal=False, window=0, softcap=0.0)),
        cuda_core_binding=host_us(lambda: fa_kernel.flash_attention_bshd(
            q, k, v, causal=False, window=0, softcap=0.0)),
        ctypes_packed=host_us(lambda: short_lib.flash_attention_short_fwd(
            *ptrs, bad_short, 0.0, 0.0, 0)),
        cuda_core_ctypes_packed=host_us(lambda: cc_lib.flash_attention_fwd(
            *ptrs, bad_cc, 0.0, 0.0, 0)),
        pack_geometry=host_us(lambda: fa_kernel._short_args(
            q, k, v, ptrs, False, 0)),
        cuda_core_pack_geometry=host_us(lambda: fa_kernel._cuda_core_args(
            q, k, v, ptrs, False, 0)))
    say(f"[2] flash attention bindings, host us per call ({smi}): "
        f"{json.dumps(binding)}; the CUDA-core kernel on the same call: "
        f"{json.dumps(cuda_core_same_call)}")
    record("flash_attention_short", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention_short.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN,
           fp32_short,
           lambda: fa(q, k, v, causal=False), lambda: plain_attn(q, k, v),
           lambda: sdpa(q, k, v),
           4 * 4 * 256 * 17 * 144, 4 * 256 * 4 * 17 * 17 * 36,
           [256, 17, 4, 36],
           mode="non-causal fp32, q/k/v views of the DiT's QKV buffer",
           library_call="scaled_dot_product_attention",
           launch_floor_ms=graph_ms(
               lambda: fa_kernel.short_empty_launch(q, k, v)),
           cuda_core_kernel_same_call=cuda_core_same_call,
           host_us_breakdown=binding, bf16_checks=bf16_short,
           max_bf16_abs_err=max(c["max_abs_err"] for c in bf16_short),
           max_bf16_row_rel_err=max(c["max_row_rel_err"] for c in bf16_short),
           memory_only_ms=graph_ms(
               lambda: fa_kernel.short_memory_only_launch(q, k, v)),
           geometry=dict(heads_per_block=hb, kv_heads_per_block=nkv,
                         warps_per_block=hb, shared_bytes=smem, blocks=blocks,
                         sms=sm_count,
                         resident_blocks_per_sm=fa_kernel.short_occupancy(
                             q, k, v),
                         warps_per_sm_at_most=hb * -(-blocks // sm_count)))

    # the CUDA-core kernel at a length past the short kernel's: a DiT over
    # 56 x 56 patches and the conditioning token (224 px at patch 4), q, k, v
    # views of its QKV buffer at head dim 32; then its tile edges (S 33,
    # 63-65, 127-129) in every mode at each head-dim class, fp32, and bf16
    # at head dims the tensor cores do not take (36, 40), drawn from a
    # generator of their own; its instances with ptxas's registers and how
    # many blocks fit an SM.  Its launches are counted in 7b's 224-px DiT
    g17 = torch.Generator(dev).manual_seed(17)

    def randn17(*shape):
        return torch.randn(shape, generator=g17, device=dev)

    B, S, H, hd = 4, 3137, 4, 32
    q, k, v = long_qkv
    cuda_core_checks = [attn_check(q, k, v, "cuda_core")]
    check(torch.equal(fa(q, k, v, causal=False), fa(q, k, v, causal=False)),
          "flash_attention (CUDA cores): two calls differ")
    # (causal, window, softcap, kv heads of 4, q scale)
    cc_modes = ((False, 0, 0.0, 4, 1.0), (True, 0, 0.0, 4, 1.0),
                (True, 40, 0.0, 4, 1.0), (True, 40, 50.0, 2, 10.0),
                (False, 0, 50.0, 1, 10.0))
    for dt, hds in ((torch.float32, (32, 36, 64, 80, 128, 256)),
                    (torch.bfloat16, (36, 40))):
        for S_ in (33, 63, 64, 65, 127, 128, 129):
            for hd_ in hds:
                for causal, window, cap, hkv, sharp in cc_modes:
                    qq, kk, vv = (randn17(2, S_, h, hd_) for h in (4, hkv, hkv))
                    cuda_core_checks.append(attn_check(
                        (qq * sharp).to(dt), kk.to(dt),
                        (vv * (0.5 if sharp > 1 else 1.0)).to(dt),
                        "cuda_core", causal=causal, window=window,
                        softcap=cap))
    fp32_cc = [c for c in cuda_core_checks if c["dtype"] == "float32"]
    bf16_cc = [c for c in cuda_core_checks if c["dtype"] == "bfloat16"]
    say(f"[2] flash_attention.cu tile edges: {len(fp32_cc)} fp32 and "
        f"{len(bf16_cc)} bf16 checks; largest errors "
        + json.dumps(sorted(fp32_cc, key=lambda c: -c["max_abs_err"])[:3]))
    dev_index = q.get_device()
    cc_instances = [dict(i, shared_bytes=fa_kernel.cuda_core_smem(i["hdp"]),
                         blocks_per_sm=fa_kernel.cuda_core_occupancy(
                             getattr(torch, i["dtype"]), i["hdp"], dev_index),
                         tiles=fa_kernel.CUDA_CORE_TILES[i["hdp"]])
                    for i in cc_instances]
    say(f"[2] flash_attention.cu instances (dtype, head-dim class: ptxas "
        f"registers, spill bytes, shared bytes, blocks an SM, (BM, BN)): "
        + "; ".join(f"{i['dtype']} {i['hdp']}: {i['registers']}, "
                    f"{i['spill_bytes']}, {i['shared_bytes']}, "
                    f"{i['blocks_per_sm']}, {i['tiles']}"
                    for i in cc_instances))
    geo = fa_kernel.cuda_core_geometry(B, H, H, S, hd)
    record("flash_attention_s3137", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN,
           fp32_cc,
           lambda: fa(q, k, v, causal=False), lambda: plain_attn(q, k, v),
           lambda: sdpa(q, k, v),
           4 * 4 * B * S * H * hd, 4 * B * H * S * S * hd, [B, S, H, hd],
           iters=20,
           mode="non-causal fp32, q/k/v views of the QKV buffer of a DiT at "
                "224 px (S = 56 * 56 + 1), CUDA-core kernel",
           library_call="scaled_dot_product_attention",
           launch_floor_ms=graph_ms(
               lambda: fa_kernel.cuda_core_empty_launch(q, k, v)),
           bf16_checks=bf16_cc,
           max_bf16_abs_err=max(c["max_abs_err"] for c in bf16_cc),
           max_bf16_row_rel_err=max(c["max_row_rel_err"] for c in bf16_cc),
           geometry=dict(zip(("hdp", "BM", "BN", "heads_per_block",
                              "positions_per_block", "position_tiles",
                              "blocks", "shared_bytes"), geo)),
           instances=cc_instances)
    del q, k, v, long_qkv

    # -- 3. the DiT at full width --------------------------------------------
    dc = DiffusionConfig(d_model=144, num_layers=4, num_heads=4, patch=4,
                         cond_dim=512)
    model = DiT(dc, 16, 3, generator=torch.Generator(dev).manual_seed(1),
                device=dev)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    model.eval()
    plain = copy.deepcopy(model)   # the reference: plain PyTorch versions
    plain.plain = True
    B = 256
    xt, yy = randn(B, 16, 16, 3), randn(B, 512)
    tt = torch.randint(0, 1000, (B,), generator=g, device=dev)
    with torch.inference_mode():
        for y_in in (yy, None):
            ref = plain(xt, tt, y_in)
            out = model(xt, tt, y_in)
            err = max_err(out, ref)
            check(float(ref.abs().max()) > 1e-3, "vacuous DiT parity")
            check(err <= TOL_DIT, f"DiT kernel path vs plain {err:.3g}")
            say(f"[3] DiT B={B} y={'given' if y_in is not None else 'null'}: "
                f"max|ref| {float(ref.abs().max()):.3f}, kernel vs plain "
                f"max_abs_err {err:.3g} (tol {TOL_DIT:g})")
        dit_ms = cuda_ms(lambda: model(xt, tt, yy), 20)
        dit_plain_ms = cuda_ms(lambda: plain(xt, tt, yy), 20)
        dit_dev_ms = graph_ms(lambda: model(xt, tt, yy), 5)
        dit_host_ms = host_us(lambda: model(xt, tt, yy), 100) * 1e-3
    say(f"[3] DiT call at B={B}: kernel path {dit_ms:.3f} ms per call, "
        f"{dit_host_ms:.3f} ms of host time and {dit_dev_ms:.3f} ms on the "
        f"device; plain path {dit_plain_ms:.3f} ms per call ({smi})")

    # -- 3b. the classifier on the card --------------------------------------
    # ResNet-18 at a mixed wave's width: logits and the guidance gradient
    # ∇ log p(y|x) against the CPU run of the same weights, and whether
    # cuDNN's own choice of backward algorithms repeats bit for bit.  The
    # gradient of a ReLU net jumps where a ReLU input crosses 0, and the
    # card and the CPU round those inputs differently by ~1e-7, so the
    # gradient is gated on the samples whose ReLU inputs (CPU run) all lie
    # at least 1e-6 from 0; the error over every sample is printed
    clf = init_classifier(torch.Generator(dev).manual_seed(7), "resnet18", 10,
                          device=dev)
    logprob = classifier_logprob(clf)
    xc = torch.rand((120, 16, 16, 3), generator=g, device=dev) * 2 - 1
    yc = torch.randint(0, 10, (120,), generator=g, device=dev)
    clf_cpu = copy.deepcopy(clf).cpu()

    def unit(v):
        return v / v.flatten(1).norm(dim=1).clamp(min=1e-6)[:, None, None,
                                                           None]

    relu, margins = torch.nn.functional.relu, []

    def recorded_relu(v, *args, **kwargs):
        margins.append(v.detach().abs().flatten(1).amin(1))
        return relu(v, *args, **kwargs)

    with torch.no_grad():
        torch.nn.functional.relu = recorded_relu
        try:
            logits_cpu = clf_cpu(xc.cpu())
        finally:
            torch.nn.functional.relu = relu
        margin = torch.stack(margins).amin(0)
        smooth = margin > 1e-6
        err_logits = max_err(clf(xc).cpu(), logits_cpu)
        grad = guid._logprob_grad(logprob, xc, yc)
        grad_err = (unit(grad).cpu() - unit(guid._logprob_grad(
            classifier_logprob(clf_cpu), xc.cpu(), yc.cpu()))).abs() \
            .flatten(1).amax(1)
        err_grad = float(grad_err[smooth].max())
        with torch.enable_grad():
            free = []
            for _ in range(2):
                z_ = xc.clone().requires_grad_(True)
                free.append(torch.autograd.grad(logprob(z_, yc).sum(), z_)[0])
        clf_ms = cuda_ms(lambda: guid._logprob_grad(logprob, xc, yc), 20)
    check(int(smooth.sum()) >= 100, f"only {int(smooth.sum())} of 120 "
          f"classifier samples clear of ReLU kinks")
    check(err_logits <= TOL_CLF and err_grad <= TOL_CLF,
          f"resnet18 card vs CPU: logits {err_logits:.3g}, normalised "
          f"gradient {err_grad:.3g} (tol {TOL_CLF:g})")
    say(json.dumps({"classifier": {
        "name": "resnet18", "batch": 120, "logits_max_abs_err_vs_cpu":
        err_logits, "unit_grad_max_abs_err_vs_cpu": err_grad,
        "samples_gated": int(smooth.sum()),
        "unit_grad_max_abs_err_all_samples": float(grad_err.max()),
        "relu_margin_of_worst_sample": float(margin[grad_err.argmax()]),
        "tol": TOL_CLF, "forward_plus_input_grad_ms": clf_ms,
        "default_cudnn_grads_repeat_bitwise": bool(torch.equal(*free)),
        "card": smi}}))

    # -- 4. the slice: client encodings → D_syn ------------------------------
    # benchmarks/common.py's paper preset; its DM pre-training pool is drawn
    # after the client shards, so leaving it out changes no client image
    data = make_federated_data(DataConfig(num_categories=10,
                                          train_per_cat_dom=10,
                                          test_per_cat_dom=8))
    t0 = time.perf_counter()
    enc, present = client_encodings(FrozenFM(), data, device=dev)
    t_enc = time.perf_counter() - t0
    k_samples, wave, num_steps = 30, 128, dc.sample_timesteps
    fns = {"cfg_update": cfg_ops.cfg_update, "adaln_norm": an_ops.adaln_norm,
           "flash_attention": fa_ops.flash_attention,
           "cfg_update_rowwise": cfg_ops.cfg_update_rowwise,
           "cfg_update_mixed": cfg_ops.cfg_update_mixed,
           "rmsnorm": rn_ops.rmsnorm}
    n_rows = int(present.sum()) * k_samples
    n_waves = math.ceil(n_rows / wave)          # near-uniform: 15 of 120
    wave_steps = n_waves * num_steps
    want = {"cfg_update": wave_steps,
            "flash_attention": wave_steps * dc.num_layers,
            "adaln_norm": wave_steps * (2 * dc.num_layers + 1),
            "cfg_update_rowwise": 0, "cfg_update_mixed": 0, "rmsnorm": 0}
    # per-wave wall times: the engine's sampler calls, each timed to its
    # end on the device
    wave_walls = []

    def timed(sampler):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = sampler(*args, **kwargs)
            torch.cuda.synchronize()
            wave_walls.append(time.perf_counter() - t)
            return out
        return call

    serve_synthesis.sample_cfg = timed(sample_cfg)
    rounds = []
    # two rounds from one key: the same D_syn, and the run-to-run spread
    for rnd in (1, 2):
        for fn in fns.values():
            fn.launches = 0
        cfg_ops.cfg_update.launches_keyed = 0
        fa_ops.flash_attention.launches_short = 0
        fa_ops.flash_attention.launches_cuda_core = 0
        fa_ops.flash_attention.launches_tensor_core = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wave_walls.clear()
        t0 = time.perf_counter()
        images, labels = synthesize(
            prng.PRNGKey(2), model, sched, enc, present, k_samples,
            image_size=16, wave_size=wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
        routes = {r: getattr(fa_ops.flash_attention, f"launches_{r}")
                  for r in ("short", "tensor_core", "cuda_core")}
        peak = torch.cuda.max_memory_allocated()
        check(launches == want, f"round {rnd}: launches {launches} != "
              f"expected {want}")
        # every step's noise drawn in the update kernel
        keyed4 = cfg_ops.cfg_update.launches_keyed
        check(keyed4 == wave_steps, f"round {rnd}: {keyed4} keyed "
              f"cfg_update launches, want {wave_steps}")
        check(routes == {"short": want["flash_attention"], "tensor_core": 0,
                         "cuda_core": 0},
              f"round {rnd}: attention routes {routes}, want all "
              f"{want['flash_attention']} on the short kernel")
        check(n_rows == 1800, f"{n_rows} D_syn rows, expected 1800")
        check(len(wave_walls) == n_waves == 15, f"{len(wave_walls)} waves")
        check(tuple(images.shape) == (n_rows, 16, 16, 3),
              f"D_syn shape {tuple(images.shape)}")
        check(bool(torch.isfinite(images).all()), "non-finite D_syn")
        check(float(images.abs().max()) <= 1.0, "D_syn outside [-1, 1]")
        check(torch.bincount(labels, minlength=10).tolist() == [180] * 10,
              "labels are not 180 per category")
        rounds.append(dict(round=rnd, images_per_s=n_rows / wall,
                           wall_s=wall, peak_mib=peak / 2**20,
                           wave_walls_s=list(wave_walls)))
        if rnd == 1:
            first_images = images
            kernels["adaln_norm"]["launches"] = launches["adaln_norm"]
            kernels["cfg_update_keyed"]["launches"] = keyed4
            kernels["cfg_update"]["launches"] = launches["cfg_update"] - keyed4
            kernels["flash_attention_short"]["launches"] = routes["short"]
        else:
            check(torch.equal(images, first_images),
                  f"round {rnd}: D_syn differs from round 1's, same key")
            say(f"[4] D_syn: {n_rows} images {tuple(images.shape)} finite in "
                f"[-1, 1]; encodings {t_enc:.3f} s; launches {launches} == "
                f"expected; attention routes {routes}")
        say(f"[4] synthesis round {rnd}: {n_rows / wall:.1f} images/s, wall "
            f"{wall:.3f} s, peak memory {peak / 2**20:.1f} MiB, {wave_steps} "
            f"wave-steps ({smi})")
    serve_synthesis.sample_cfg = sample_cfg
    rates = [r["images_per_s"] for r in rounds]
    say(json.dumps({"synthesis": {
        "rounds": rounds, "images": n_rows, "wave_steps": wave_steps,
        "spread": (max(rates) - min(rates)) / min(rates), "card": smi}}))

    # a 4-step wave, kernel path against the plain DiT on the same draws
    # (both take cfg_update's kernel, bit-equal to its plain version at
    # this trajectory's first step in phase 2)
    rows = torch.as_tensor(enc[present][:8], device=dev)
    x_T, noise = randn(8, 16, 16, 3), randn(4, 8, 16, 16, 3)
    n0 = cfg_ops.cfg_update.launches
    out, ref = (sample_cfg(m, sched, rows, num_steps=4, x_T=x_T, noise=noise)
                for m in (model, plain))
    # z from memory: the x_T= / noise= injection
    kernels["cfg_update"]["launches_4_step_injected_noise_waves"] = \
        cfg_ops.cfg_update.launches - n0
    err = max_err(out, ref)
    check(float(ref.abs().max()) > 1e-3, "vacuous 4-step parity")
    check(err <= TOL_E2E, f"4-step wave kernel vs plain {err:.3g}")
    say(f"[4] 4-step wave of 8 rows: kernel path vs plain path max_abs_err "
        f"{err:.3g} (tol {TOL_E2E:g})")

    # -- 5. where a wave's time goes -----------------------------------------
    # one 128-row wave through synthesize (4 encodings x 32 samples), first
    # untraced, then under the profiler; the device's busy time is the
    # union of the kernel and copy intervals in the trace
    def one_wave():
        return synthesize(prng.PRNGKey(4), model, sched, enc[:1], present[:1]
                          & (np.arange(enc.shape[1]) < 4), 32, image_size=16,
                          wave_size=wave)

    check(one_wave()[0].shape[0] == wave, "the traced call is not one wave")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_wave()
    torch.cuda.synchronize()
    wave_wall = time.perf_counter() - t0
    trace = device_busy(one_wave, BUILD_DIR / "wave_trace.json")
    say(json.dumps({"wave_trace": {
        "rows": wave, "steps": num_steps, **trace,
        "untraced_wall_s": wave_wall, "device_idle_share_of_untraced_wall":
        1 - trace["device_busy_s"] / wave_wall,
        "dit_call_ms": dit_ms, "dit_host_ms": dit_host_ms,
        "dit_device_ms": dit_dev_ms, "card": smi}}))

    # -- 6. ragged synthesis: mixed (guidance, steps) ------------------------
    # the reference benchmark's mixed workload (benchmarks/
    # synthesis_throughput.py::_mixed_reqs): the 60 uploads, in (client,
    # category) order, take these (guidance, steps) in turn, 30 samples each
    combos = [(1.5, 50), (4.0, 50), (7.5, 25), (1.5, 25)]
    uploads = [(r, c) for r in range(enc.shape[0])
               for c in range(enc.shape[1]) if present[r, c]]
    check(len(uploads) == 60, f"{len(uploads)} uploads, expected 60")
    key6 = prng.PRNGKey(6)

    def mixed_engine(compaction):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=wave,
                              ragged=True, compaction=compaction)
        for i, (r, c) in enumerate(uploads):
            g6, s6 = combos[i % len(combos)]
            eng.submit(enc[r, c], c, k_samples, guidance=g6, num_steps=s6)
        return eng

    # the plan the engine must follow: 15 waves of 120 rows in request
    # order, a running step ceiling, and for compaction each wave's epochs
    row_steps = np.repeat([combos[i % 4][1] for i in range(60)], k_samples)
    plan = {"ragged": dict(iters=0, scheduled=0, segments=0),
            "compacted": dict(iters=0, scheduled=0, segments=0)}
    smax = 0
    for w in range(0, n_rows, 120):
        st_w = row_steps[w:w + 120]
        smax = max(smax, int(st_w.max()))
        plan["ragged"]["iters"] += smax
        plan["ragged"]["scheduled"] += 120 * smax
        _, epochs = guid.plan_epochs(st_w, smax, compaction="full")
        plan["compacted"]["iters"] += sum(e - b for _, b, e in epochs)
        plan["compacted"]["scheduled"] += sum(r * (e - b)
                                              for r, b, e in epochs)
        plan["compacted"]["segments"] += len(epochs)
    active_iters = int(row_steps.sum())
    check(plan["ragged"]["scheduled"] == 90000 and active_iters == 67500
          and plan["compacted"]["scheduled"] == 67500,
          f"phase 6 plan {plan}, active {active_iters}")

    samplers = (serve_synthesis.sample_cfg_ragged,
                serve_synthesis.sample_cfg_compacted)
    serve_synthesis.sample_cfg_ragged = timed(samplers[0])
    serve_synthesis.sample_cfg_compacted = timed(samplers[1])
    mixed_rounds, d_syn = [], {}
    for mode, compaction in (("ragged", None), ("compacted", "full")):
        for rnd in (1, 2):
            eng = mixed_engine(compaction)
            for fn in fns.values():
                fn.launches = 0
            cfg_ops.cfg_update_rowwise.launches_keyed = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wave_walls.clear()
            t0 = time.perf_counter()
            out6 = eng.run(key6)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in fns.items()}
            peak = torch.cuda.max_memory_allocated()
            images = torch.cat([out6[rid] for rid in range(60)])
            check(tuple(images.shape) == (n_rows, 16, 16, 3),
                  f"{mode} D_syn shape {tuple(images.shape)}")
            check(bool(torch.isfinite(images).all())
                  and float(images.abs().max()) <= 1.0,
                  f"{mode} D_syn not finite in [-1, 1]")
            p6 = plan[mode]
            want_stats = dict(waves=15, generated=n_rows,
                              scheduled_rows=n_rows, padded=0,
                              merged_waves=15, segments=p6["segments"],
                              row_iters_scheduled=p6["scheduled"],
                              row_iters_active=active_iters)
            check(eng.stats == want_stats, f"{mode} round {rnd}: stats "
                  f"{eng.stats} != {want_stats}")
            want6 = {"cfg_update": 0, "cfg_update_mixed": 0, "rmsnorm": 0,
                     "cfg_update_rowwise": p6["iters"],
                     "flash_attention": p6["iters"] * dc.num_layers,
                     "adaln_norm": p6["iters"] * (2 * dc.num_layers + 1)}
            check(launches == want6, f"{mode} round {rnd}: launches "
                  f"{launches} != expected {want6}")
            keyed6 = cfg_ops.cfg_update_rowwise.launches_keyed
            check(keyed6 == p6["iters"], f"{mode} round {rnd}: {keyed6} "
                  f"keyed rowwise launches, want {p6['iters']}")
            if rnd == 1:
                d_syn[mode] = images
                if mode == "ragged":
                    kernels["cfg_update_rowwise_keyed"]["launches"] = keyed6
                    kernels["cfg_update_rowwise"]["launches"] = \
                        launches["cfg_update_rowwise"] - keyed6
            else:
                check(torch.equal(images, d_syn[mode]),
                      f"{mode} round {rnd}: D_syn differs from round 1's")
            mixed_rounds.append(dict(
                mode=mode, round=rnd, images_per_s=n_rows / wall,
                wall_s=wall, peak_mib=peak / 2**20, stats=eng.stats,
                launches=launches, wave_walls_s=list(wave_walls)))
            say(f"[6] {mode} round {rnd}: {n_rows / wall:.1f} images/s, wall "
                f"{wall:.3f} s, peak memory {peak / 2**20:.1f} MiB, "
                f"row-iterations {eng.stats['row_iters_scheduled']} "
                f"scheduled / {eng.stats['row_iters_active']} active, "
                f"launches {launches} ({smi})")
    (serve_synthesis.sample_cfg_ragged,
     serve_synthesis.sample_cfg_compacted) = samplers
    err_pack = max_err(d_syn["ragged"], d_syn["compacted"])
    check(err_pack <= TOL_E2E_DEEP, f"ragged vs compacted D_syn {err_pack:.3g}")
    say(f"[6] ragged vs compacted D_syn (1800 images, 50/25 steps): "
        f"max_abs_err {err_pack:.3g} (tol {TOL_E2E_DEEP:g})")

    # one 120-row 4-step wave: two 60-row windows against the wave-wide
    # table (the second at row_offset 60) against the whole wave, and the
    # whole wave on the kernel path against the plain DiT
    combos4 = [(1.5, 4), (4.0, 4), (7.5, 2), (1.5, 2)]
    y4 = torch.as_tensor(np.repeat(enc[present][:4], 30, axis=0), device=dev)
    g4 = np.repeat([c[0] for c in combos4], 30).astype(np.float32)
    s4 = np.repeat([c[1] for c in combos4], 30)
    keys4 = prng.fold_in(prng.fold_in(key6[None], np.repeat(np.arange(4), 30)),
                         np.tile(np.arange(30), 4))
    cfg_ops.cfg_update_rowwise.launches = 0
    whole = sample_cfg_ragged(model, sched, y4, keys4, g4, s4)
    halves = [sample_cfg_window(model, sched, y4[o:o + 60], keys4[o:o + 60],
                                g4, s4, row_offset=o) for o in (0, 60)]
    check(cfg_ops.cfg_update_rowwise.launches == 12,
          f"{cfg_ops.cfg_update_rowwise.launches} rowwise launches for one "
          f"wave and two windows of 4 steps, expected 12")
    err_win = max_err(torch.cat(halves), whole)
    check(err_win <= TOL_E2E, f"windows vs whole wave {err_win:.3g}")
    say(f"[6] 4-step ragged wave of 120 rows: two windows (row_offset 0, 60) "
        f"vs whole max_abs_err {err_win:.3g} (tol {TOL_E2E:g})")
    # kernel path against the plain DiT from the same row keys: 8 rows of
    # all four (guidance, steps) at 4 steps, as phase 4 holds sample_cfg,
    # and the whole 120-row wave at 50/25 steps.  A 4-step wave's first
    # step divides by √ᾱ_999 ≈ 5e-5, so in a wave of 92160 values a few
    # unclipped ones carry the DiT's ~2e-6 per-call difference times
    # ~2e4·(1 + 2s); at 20+ steps the step-aware gate is 2e-2
    pick = [0, 1, 30, 31, 60, 61, 90, 91]
    err_plain = max_err(whole[pick], sample_cfg_ragged(
        plain, sched, y4[pick], keys4[pick], g4[pick], s4[pick]))
    check(err_plain <= TOL_E2E, f"4-step ragged rows kernel vs plain "
          f"{err_plain:.3g}")
    err_plain_120 = max_err(whole, sample_cfg_ragged(plain, sched, y4, keys4,
                                                     g4, s4))
    g50 = np.repeat([c[0] for c in combos], 30).astype(np.float32)
    s50 = np.repeat([c[1] for c in combos], 30)
    deep, deep_plain = (sample_cfg_ragged(m, sched, y4, keys4, g50, s50)
                        for m in (model, plain))
    err_plain_deep = max_err(deep, deep_plain)
    check(float(deep_plain.abs().max()) > 1e-3, "vacuous ragged parity")
    check(err_plain_deep <= TOL_E2E_DEEP, f"50/25-step ragged wave kernel "
          f"vs plain {err_plain_deep:.3g}")
    say(f"[6] ragged wave, kernel path vs plain DiT: 8 rows at 4/2 steps "
        f"max_abs_err {err_plain:.3g} (tol {TOL_E2E:g}); 120 rows at 50/25 "
        f"steps {err_plain_deep:.3g} (tol {TOL_E2E_DEEP:g}); 120 rows at "
        f"4/2 steps {err_plain_120:.3g} (not gated, see above)")

    # the threefry draws of one 120-row wave of 50 steps: the grouped
    # wave's 51 keys (x_T and the steps) and the ragged wave's 50 x 120
    # row-step keys, each drawn in one call, as the samplers drew them
    # before the loop until the update kernels drew their own (the mixed
    # waves too, since the mixed variant draws); and what stays eager on
    # the card: each wave's x_T
    chain, k = [], key6
    for _ in range(51):
        k, sub = prng.split(k)
        chain.append(sub)
    chain = np.stack(chain)
    t0 = time.perf_counter()
    row_step_keys = prng.fold_in(keys4[None], np.arange(1, 51)[:, None])
    t_keys = time.perf_counter() - t0
    grouped_ms = cuda_ms(lambda: prng.normal(chain, (120, 16, 16, 3), dev), 10)
    ragged_ms = cuda_ms(lambda: prng.normal(row_step_keys, (16, 16, 3), dev),
                        10)
    x_T_keys = prng.fold_in(keys4, 0)
    say(json.dumps({"threefry": {
        "grouped_wave_draw_ms": grouped_ms, "ragged_wave_draw_ms": ragged_ms,
        "ragged_host_key_derivation_ms": t_keys * 1e3,
        "grouped_wave_noise_bytes": 4 * 51 * 120 * 768,
        "still_eager": {
            "grouped_x_T_ms": cuda_ms(lambda: prng.normal(
                chain[0], (120, 16, 16, 3), dev), 10),
            "ragged_x_T_ms": cuda_ms(lambda: prng.normal(
                x_T_keys, (16, 16, 3), dev), 10)},
        "drawn_in_the_update_kernel": "the step noise of uniform, ragged, "
        "compacted and windowed classifier-free waves and of mixed "
        "guidance-mode waves", "card": smi}}))
    rates6 = {m: [r["images_per_s"] for r in mixed_rounds if r["mode"] == m]
              for m in ("ragged", "compacted")}
    say(json.dumps({"mixed_synthesis": {
        "rounds": mixed_rounds, "plan": plan, "active_iters": active_iters,
        "images_per_s": rates6, "ragged_vs_compacted_max_abs_err": err_pack,
        "windows_vs_whole_max_abs_err": err_win,
        "ragged_kernel_vs_plain_max_abs_err": {
            "8_rows_4_steps": err_plain, "120_rows_50_steps": err_plain_deep,
            "120_rows_4_steps": err_plain_120}, "card": smi}}))

    # -- 7. mixed guidance modes ---------------------------------------------
    # the reference benchmark's _bench_mixed_guidance request set at the
    # paper preset: the 60 uploads of phase 6 (rids 0-59), one
    # classifier-guided request per category (rids 60-69: guidance 1.0, 25
    # steps and the first classifier for an even category, 50 steps and
    # the second for an odd one) and four unconditional requests (rids
    # 70-73: 50 steps for an even category, 25 for an odd one), 30 samples
    # each.  The classifiers are two seeded ResNet-18s, as two clients
    # would upload them: the repository has no trained one yet.
    clfs = [classifier_logprob(init_classifier(
        torch.Generator(dev).manual_seed(70 + i), "resnet18", 10,
        device=dev)) for i in range(2)]
    clf_reqs = [(c, 50 if c % 2 else 25) for c in range(10)]
    unc_reqs = [(c, 25 if c % 2 else 50) for c in range(4)]
    key7 = prng.PRNGKey(7)

    def engine7(compaction=None, modes=("cfg", "clf", "uncond")):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=wave,
                              ragged=True, compaction=compaction)
        if "cfg" in modes:
            for i, (r, c) in enumerate(uploads):
                g7, s7 = combos[i % len(combos)]
                eng.submit(enc[r, c], c, k_samples, guidance=g7,
                           num_steps=s7)
        eng._next_rid = 60          # the rids of the whole request set
        if "clf" in modes:
            for c, s7 in clf_reqs:
                eng.submit_classifier_guided(clfs[c % 2], c, k_samples,
                                             guidance=1.0, num_steps=s7,
                                             group=("clf", c))
        eng._next_rid = 70
        if "uncond" in modes:
            for c, s7 in unc_reqs:
                eng.submit_unconditional(k_samples, category=c, num_steps=s7)
        return eng

    # the plan: near-uniform FIFO waves of the 2220 rows, padding repeating
    # the last row, a running step ceiling; a wave holding a classifier row
    # updates through cfg_update_mixed, any other through
    # cfg_update_rowwise
    rows7 = ([(combos[i % 4][1], 0) for i in range(60) for _ in range(30)]
             + [(s7, 1) for _, s7 in clf_reqs for _ in range(30)]
             + [(s7, 0) for _, s7 in unc_reqs for _ in range(30)])
    n7 = len(rows7)
    nw = -(-n7 // wave)
    w7 = -(-(-(-n7 // nw)) // 8) * 8
    plan7 = {m: dict(mixed=0, rowwise=0, scheduled=0, segments=0)
             for m in ("ragged", "compacted")}
    smax = 0
    for w in range(nw):
        part = rows7[w * w7:(w + 1) * w7]
        part = part + [part[-1]] * (w7 - len(part))
        st_w = np.array([r[0] for r in part])
        smax = max(smax, int(st_w.max()))
        kind = "mixed" if any(r[1] for r in part) else "rowwise"
        plan7["ragged"][kind] += smax
        plan7["ragged"]["scheduled"] += w7 * smax
        _, epochs = guid.plan_epochs(st_w, smax, compaction="full")
        plan7["compacted"][kind] += sum(e - b for _, b, e in epochs)
        plan7["compacted"]["scheduled"] += sum(r * (e - b)
                                               for r, b, e in epochs)
        plan7["compacted"]["segments"] += len(epochs)
    active7 = sum(r[0] for r in rows7)
    check(n7 == 2220 and nw == 18 and w7 == 128 and active7 == 83250
          and plan7["ragged"]["mixed"] == 150, f"phase 7 plan {plan7}")

    rounds7, d_syn7 = [], {}
    for mode, compaction in (("ragged", None), ("compacted", "full")):
        for rnd in (1, 2):
            eng = engine7(compaction)
            for fn in fns.values():
                fn.launches = 0
            cfg_ops.cfg_update_rowwise.launches_keyed = 0
            cfg_ops.cfg_update_mixed.launches_keyed = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out7 = eng.run(key7)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in fns.items()}
            peak = torch.cuda.max_memory_allocated()
            check(sorted(out7) == list(range(74)), f"{mode}: rids "
                  f"{sorted(out7)}")
            images = torch.cat([out7[rid] for rid in range(74)])
            check(tuple(images.shape) == (n7, 16, 16, 3),
                  f"{mode} mixed-mode D_syn shape {tuple(images.shape)}")
            check(bool(torch.isfinite(images).all())
                  and float(images.abs().max()) <= 1.0,
                  f"{mode} mixed-mode D_syn not finite in [-1, 1]")
            p7 = plan7[mode]
            want_stats = dict(waves=nw, generated=n7,
                              scheduled_rows=nw * w7, padded=nw * w7 - n7,
                              merged_waves=nw, segments=p7["segments"],
                              row_iters_scheduled=p7["scheduled"],
                              row_iters_active=active7)
            check(eng.stats == want_stats, f"{mode} round {rnd}: stats "
                  f"{eng.stats} != {want_stats}")
            iters = p7["mixed"] + p7["rowwise"]
            want7 = {"cfg_update": 0, "cfg_update_mixed": p7["mixed"],
                     "rmsnorm": 0,
                     "cfg_update_rowwise": p7["rowwise"],
                     "flash_attention": iters * dc.num_layers,
                     "adaln_norm": iters * (2 * dc.num_layers + 1)}
            check(launches == want7, f"{mode} round {rnd}: launches "
                  f"{launches} != expected {want7}")
            # every step's noise drawn in the update kernels, mixed waves'
            # too
            keyed7 = (cfg_ops.cfg_update_mixed.launches_keyed,
                      cfg_ops.cfg_update_rowwise.launches_keyed)
            check(keyed7 == (p7["mixed"], p7["rowwise"]),
                  f"{mode} round {rnd}: keyed (mixed, rowwise) launches "
                  f"{keyed7}, want {(p7['mixed'], p7['rowwise'])}")
            if rnd == 1:
                d_syn7[mode] = out7
                if mode == "ragged":
                    kernels["cfg_update_mixed_keyed"]["launches"] = keyed7[0]
                    kernels["cfg_update_mixed"]["launches"] = \
                        launches["cfg_update_mixed"] - keyed7[0]
                    # the D_syn's bits, to compare with another tree's run
                    sha7 = hashlib.sha256(b"".join(
                        out7[r].float().cpu().numpy().tobytes()
                        for r in range(74))).hexdigest()
                    say(f"[7] ragged round 1 D_syn sha256 (rids 0-73 in "
                        f"order, fp32 bytes): {sha7}")
            else:
                check(all(torch.equal(out7[r], d_syn7[mode][r])
                          for r in out7),
                      f"{mode} round {rnd}: mixed-mode D_syn differs from "
                      f"round 1's, same key")
            rounds7.append(dict(
                mode=mode, round=rnd, images_per_s=n7 / wall, wall_s=wall,
                peak_mib=peak / 2**20, stats=eng.stats, launches=launches))
            say(f"[7] {mode} round {rnd}: {n7} images, {n7 / wall:.1f} "
                f"images/s, wall {wall:.3f} s, peak memory "
                f"{peak / 2**20:.1f} MiB, row-iterations "
                f"{eng.stats['row_iters_scheduled']} scheduled / "
                f"{eng.stats['row_iters_active']} active, launches "
                f"{launches} ({smi})")

    def rid_err(a, b):          # over the rids of a
        return max(max_err(a[r], b[r]) for r in a)

    err7_pack = rid_err(d_syn7["ragged"], d_syn7["compacted"])
    check(err7_pack <= TOL_E2E_DEEP, f"mixed ragged vs compacted D_syn "
          f"{err7_pack:.3g}")
    # each mode alone, in an engine of its own with the same rids
    err7_iso = {}
    for modes in (("cfg",), ("clf",), ("uncond",)):
        alone = engine7(None, modes).run(key7)
        err7_iso[modes[0]] = rid_err(alone, d_syn7["ragged"])
    check(max(err7_iso.values()) <= TOL_E2E_DEEP,
          f"merged vs isolated-mode D_syn {err7_iso}")
    say(f"[7] merged vs isolated-mode D_syn max_abs_err {err7_iso}, ragged "
        f"vs compacted {err7_pack:.3g} (tol {TOL_E2E_DEEP:g})")

    # one 120-row mixed wave, 40 rows of each mode, the classifier rows on
    # both classifiers: at 4/2 steps on the kernel path against the plain
    # DiT (printed: the t = 999 first step amplifies the DiT's per-call
    # difference, as in phase 6), then at 50/25 steps traced
    null = model.null_y.detach()
    y7 = torch.cat([torch.as_tensor(np.repeat(enc[present][:4], 10, axis=0),
                                    device=dev), null.expand(80, -1)])
    g7 = np.r_[np.repeat([1.5, 4.0, 7.5, 1.5], 10), np.ones(40),
               np.zeros(40)].astype(np.float32)
    m7 = np.r_[np.zeros(40), np.ones(40), np.zeros(40)].astype(np.float32)
    ids7 = np.r_[np.zeros(40), np.arange(40) % 2, np.zeros(40)]
    lab7 = np.arange(120) % 10
    keys7 = prng.split(prng.PRNGKey(8), 120)

    def wave7(m, steps):
        return sample_mixed(m, sched, y7, keys7, g7, m7, ids7, lab7,
                            np.tile(steps, 60), clf_fns=tuple(clfs))

    cfg_ops.cfg_update_mixed.launches = 0
    out4 = wave7(model, [4, 2])
    check(cfg_ops.cfg_update_mixed.launches == 4,
          f"{cfg_ops.cfg_update_mixed.launches} mixed launches for a 4-step "
          f"wave")
    ref4 = wave7(plain, [4, 2])
    check(float(ref4.abs().max()) > 1e-3, "vacuous mixed parity")
    err4 = {name: max_err(out4[sl], ref4[sl]) for name, sl in
            (("cfg", slice(0, 40)), ("clf", slice(40, 80)),
             ("uncond", slice(80, 120)))}
    say(f"[7] 4-step mixed wave of 120 rows, kernel path vs plain DiT "
        f"max_abs_err by mode {err4} (printed, not gated)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave7(model, [50, 25])
    torch.cuda.synchronize()
    wall7 = time.perf_counter() - t0
    trace7 = device_busy(lambda: wave7(model, [50, 25]),
                         BUILD_DIR / "mixed_wave_trace.json")
    rates7 = {m: [r["images_per_s"] for r in rounds7 if r["mode"] == m]
              for m in ("ragged", "compacted")}
    say(json.dumps({"mixed_guidance": {
        "rounds": rounds7, "plan": plan7, "active_iters": active7,
        "ragged_round_1_d_syn_sha256": sha7,
        "images_per_s": rates7, "ragged_vs_compacted_max_abs_err": err7_pack,
        "merged_vs_isolated_max_abs_err": err7_iso,
        "mixed_4_step_kernel_vs_plain_max_abs_err": err4,
        "mixed_wave_trace": {"rows": 120, "steps": [50, 25], **trace7,
                             "untraced_wall_s": wall7,
                             "device_idle_share_of_untraced_wall":
                             1 - trace7["device_busy_s"] / wall7},
        "card": smi}}))

    # -- 7b. the DiT at the paper's 224 px -----------------------------------
    # the paper preset's width (d_model 144, 4 heads of 36, patch 4, 512-d
    # conditioning) at image_size 224: S = 56 * 56 + 1 = 3137 tokens, past
    # the short kernel's 32, so every attention takes the CUDA-core kernel;
    # 4 layers, batch 8, seeded weights perturbed 0.05·normal.  Weights and
    # inputs come from generators of their own (later phases draw what they
    # drew before), and it runs after the synthesis rounds, whose rates it
    # would otherwise precede with a traced call
    g224 = torch.Generator(dev).manual_seed(224)
    model224 = DiT(dc, 224, 3, generator=torch.Generator(dev).manual_seed(2),
                   device=dev)
    with torch.no_grad():
        for p in model224.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g224, device=dev))
    model224.eval()
    plain224 = copy.deepcopy(model224)
    plain224.plain = True
    x224 = torch.randn((8, 224, 224, 3), generator=g224, device=dev)
    y224 = torch.randn((8, 512), generator=g224, device=dev)
    t224 = torch.randint(0, 1000, (8,), generator=g224, device=dev)
    fa = fa_ops.flash_attention
    with torch.inference_mode():
        n0 = (fa.launches, fa.launches_short, fa.launches_tensor_core,
              fa.launches_cuda_core)
        out224 = model224(x224, t224, y224)
        torch.cuda.synchronize()
        moved224 = (fa.launches - n0[0], fa.launches_short - n0[1],
                    fa.launches_tensor_core - n0[2],
                    fa.launches_cuda_core - n0[3])
        check(moved224 == (dc.num_layers, 0, 0, dc.num_layers),
              f"224-px DiT: flash launches (all, short, tensor core, CUDA "
              f"core) {moved224}, want {dc.num_layers} on the CUDA cores")
        ref224 = plain224(x224, t224, y224)
        err224 = max_err(out224, ref224)
        check(bool(torch.isfinite(out224).all())
              and tuple(out224.shape) == (8, 224, 224, 3)
              and float(ref224.abs().max()) > 1e-3,
              "224-px DiT: vacuous or non-finite output")
        check(err224 <= TOL_DIT, f"224-px DiT kernel path vs plain "
              f"{err224:.3g} > {TOL_DIT:g}")
        dit224_ms = cuda_ms(lambda: model224(x224, t224, y224), 5)
        dit224_dev_ms = graph_ms(lambda: model224(x224, t224, y224), 3)
        dit224_plain_ms = cuda_ms(lambda: plain224(x224, t224, y224), 3)
        trace224 = device_busy(lambda: model224(x224, t224, y224),
                               BUILD_DIR / "dit224_trace.json")
    kernels["flash_attention_s3137"]["launches"] = moved224[3]
    say(json.dumps({"dit_224px": {
        "image_size": 224, "tokens": 3137, "batch": 8, "d_model": dc.d_model,
        "heads": dc.num_heads, "head_dim": dc.d_model // dc.num_heads,
        "layers": dc.num_layers, "max_abs_err_vs_plain": err224,
        "tol": TOL_DIT, "max_abs_ref": float(ref224.abs().max()),
        "flash_launches_cuda_core": moved224[3], "ms_per_call": dit224_ms,
        "device_ms": dit224_dev_ms, "plain_ms_per_call": dit224_plain_ms,
        "traced_device_busy_ms": 1e3 * trace224["device_busy_s"],
        "attention_device_ms": 1e3 * trace224["flash_attention_device_s"],
        "attention_share_of_busy": trace224[
            "flash_attention_share_of_busy"],
        "top_device_us": trace224["top_device_us"][:5], "card": smi}}))
    del model224, plain224, out224, ref224, x224

    # -- 8. LM serving: gemma2-2b ---------------------------------------------
    # 8a. flash attention's modes and rmsnorm against their plain versions.
    # The grid: causal; causal + window; causal + window + softcap 50; GQA
    # 8/4 (gemma2's local mode) and the same without window (its global
    # mode); MQA 8/1; non-causal.  S = 100 (ragged
    # against the 32-row tiles) with window 40, and S = 4608 with gemma2's
    # window 4096; head dims 64, 128, 256; fp32 and bf16
    def plain_lm_attn(q, k, v, **kw):
        return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), **kw).transpose(1, 2)

    # (mode, kv heads of 8 query heads, causal, windowed, softcap 50)
    grid = [("causal", 8, True, False, False),
            ("causal_window", 8, True, True, False),
            ("causal_window_softcap", 8, True, True, True),
            ("gqa_rep2", 4, True, True, True),
            ("gqa_rep2_global", 4, True, False, True),
            ("mqa_rep8", 1, True, False, False),
            ("noncausal", 8, False, False, False)]
    attn_checks = {"float32": [], "bfloat16": []}
    fa = fa_ops.flash_attention
    for S, W, B in ((100, 40, 2), (4608, 4096, 1)):
        for hd in (64, 128, 256):
            base = [randn(B, S, 8, hd), randn(B, S, 8, hd), randn(B, S, 8, hd)]
            for dtype, tol in (("float32", TOL_ATTN),
                               ("bfloat16", TOL_ATTN_BF16)):
                dt = getattr(torch, dtype)
                for mode, hkv, causal, windowed, capped in grid:
                    q, k, v = (base[0].to(dt), base[1][:, :, :hkv].to(dt),
                               base[2][:, :, :hkv].to(dt))
                    kw = dict(causal=causal, window=W if windowed else 0,
                              softcap=50.0 if capped else 0.0)
                    routes = (fa.launches_tensor_core, fa.launches_cuda_core)
                    out = fa(q, k, v, **kw)
                    torch.cuda.synchronize()
                    tc = dtype == "bfloat16"
                    check((fa.launches_tensor_core - routes[0],
                           fa.launches_cuda_core - routes[1]) == (tc, not tc),
                          f"flash_attention {mode} S={S} hd={hd} {dtype}: "
                          f"not on the {'tensor' if tc else 'CUDA'}-core "
                          f"kernel")
                    ref = plain_lm_attn(q, k, v, **kw)
                    err, rel = max_err(out, ref), row_rel_err(out, ref)
                    check(out.dtype == dt and err <= tol,
                          f"flash_attention {mode} S={S} hd={hd} {dtype}: "
                          f"max abs error {err:.3g} > {tol:g}")
                    check(dt == torch.float32 or rel <= TOL_ATTN_BF16_ROW,
                          f"flash_attention {mode} S={S} hd={hd} bf16: "
                          f"row-relative error {rel:.3g} > "
                          f"{TOL_ATTN_BF16_ROW:g}")
                    attn_checks[dtype].append(dict(
                        mode=mode, shape=[B, S, 8, hkv, hd],
                        window=kw["window"], softcap=kw["softcap"],
                        max_abs_err=err, max_row_rel_err=rel))
            del base, q, k, v, out, ref
    say(f"[8] flash_attention mode grid: {len(attn_checks['float32'])} fp32 "
        f"checks, max_abs_err "
        f"{max(c['max_abs_err'] for c in attn_checks['float32']):.3g} (tol "
        f"{TOL_ATTN:g}); {len(attn_checks['bfloat16'])} bf16 checks, "
        f"max_abs_err "
        f"{max(c['max_abs_err'] for c in attn_checks['bfloat16']):.3g} (tol "
        f"{TOL_ATTN_BF16:g}), row-relative "
        f"{max(c['max_row_rel_err'] for c in attn_checks['bfloat16']):.3g} "
        f"(tol {TOL_ATTN_BF16_ROW:g})")

    # timed at the serving shape: one prefill layer of wave A (B 4, S 4608,
    # 8 query heads over 4 kv heads of 256, bf16), local (window 4096) and
    # global.  The library column is flex_attention, compiled, with the soft
    # cap as its score_mod and the masks as a BlockMask: one PyTorch call
    # computing the same function (the port never calls it).  SDPA (causal,
    # GQA, no softcap, no window: a different function) is printed beside it
    lm_cfg = get_config("gemma2-2b")
    Bw, Sw, hq, hkv, hd = 4, 4608, lm_cfg.num_heads, lm_cfg.num_kv_heads, \
        lm_cfg.head_dim
    qa, ka, va = (randn(Bw, Sw, h, hd).bfloat16() for h in (hq, hkv, hkv))
    kw_local = dict(causal=True, window=lm_cfg.sliding_window,
                    softcap=lm_cfg.attn_softcap)
    kw_global = dict(causal=True, window=0, softcap=lm_cfg.attn_softcap)
    n_tc = fa.launches_tensor_core
    serve_out = fa(qa, ka, va, **kw_local)
    check(fa.launches_tensor_core == n_tc + 1, "wave A's layer did not take "
          "the tensor-core kernel")
    serve_ref = plain_lm_attn(qa, ka, va, **kw_local)
    serve_err = max_err(serve_out, serve_ref)
    serve_rel = row_rel_err(serve_out, serve_ref)
    check(serve_err <= TOL_ATTN_BF16 and serve_rel <= TOL_ATTN_BF16_ROW,
          f"flash_attention at wave A's layer: max abs error {serve_err:.3g},"
          f" row-relative {serve_rel:.3g}")
    check(torch.equal(serve_out, fa(qa, ka, va, **kw_local)),
          "flash_attention at wave A's layer: two calls differ")
    try:                     # decided by import: present from PyTorch 2.5
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError:
        flex_attention = None
    flex, bhsd = {}, [t.transpose(1, 2) for t in (qa, ka, va)]
    if flex_attention is not None:
        cap, win = lm_cfg.attn_softcap, lm_cfg.sliding_window

        def score_mod(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        def local_mask(b, h, q_idx, kv_idx):
            return (kv_idx <= q_idx) & (kv_idx > q_idx - win)

        def causal_mask(b, h, q_idx, kv_idx):
            return kv_idx <= q_idx

        flex_c = torch.compile(flex_attention, dynamic=False)
        for name, mask_mod in (("local", local_mask),
                               ("global", causal_mask)):
            bm = create_block_mask(mask_mod, None, None, Sw, Sw, device=dev)
            call = (lambda bm=bm: flex_c(*bhsd, score_mod=score_mod,
                                         block_mask=bm, enable_gqa=True))
            t0 = time.perf_counter()
            fo = call()
            torch.cuda.synchronize()
            flex[name] = dict(call=call, compile_s=time.perf_counter() - t0)
            if name == "local":
                flex[name]["max_abs_err_vs_plain"] = max_err(
                    fo.transpose(1, 2), serve_ref)
            del fo
        say(f"[8] flex_attention (compiled; score_mod 50 tanh(s/50), "
            f"BlockMask, GQA): first call local "
            f"{flex['local']['compile_s']:.2f} s, global "
            f"{flex['global']['compile_s']:.2f} s; local against the plain "
            f"version: max_abs_err "
            f"{flex['local']['max_abs_err_vs_plain']:.3g}")
    else:
        say("[8] flex_attention: not in this PyTorch "
            f"({torch.__version__}); library column none")
    del serve_out, serve_ref
    # q, k, v read once and o written once, bf16
    attn_bytes = 2 * (2 * qa.numel() + ka.numel() + va.numel())
    pairs = {n: Bw * hq * attn_pairs(Sw, Sw, True, kw["window"])
             for n, kw in (("local", kw_local), ("global", kw_global))}

    def sdpa_lm():
        return torch.nn.functional.scaled_dot_product_attention(
            qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    record("flash_attention_lm", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention_tc.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN_BF16,
           attn_checks["bfloat16"] + [dict(mode="gemma2_local", shape=[
               Bw, Sw, hq, hkv, hd], max_abs_err=serve_err,
               max_row_rel_err=serve_rel)],
           lambda: fa(qa, ka, va, **kw_local),
           lambda: plain_lm_attn(qa, ka, va, **kw_local),
           flex["local"]["call"] if flex else None,
           attn_bytes, 4 * hd * pairs["local"], [Bw, Sw, hq, hkv, hd],
           peak=BF16_FLOPS, iters=5, phase=8,
           mode="causal, window 4096, softcap 50, GQA 8/4, bf16 (gemma2 "
                "local layer, wave A prefill), tensor-core kernel",
           # flash_attention_tc.cu's launch: a block of 384 threads per
           # (work item, batch, query head), its ring of 64 x 64 bf16 blocks
           launch_floor_ms=graph_ms(lambda: empty_launch(
               (fa_kernel.work_list(Sw, Sw, True, lm_cfg.sliding_window)
                .shape[0] * Bw * hq, 1), 384,
               1024 + 6 * (hd // 64) * 64 * 128 + 64,
               torch.cuda.current_device())),
           library_call=("flex_attention, compiled, score_mod softcap, "
                         "BlockMask causal + window, enable_gqa" if flex
                         else "none (no flex_attention in this PyTorch)"),
           library_max_abs_err=(flex["local"]["max_abs_err_vs_plain"]
                                if flex else None),
           sdpa_causal_gqa_ms_different_function=cuda_ms(sdpa_lm, 5),
           fp32_max_abs_err=max(c["max_abs_err"]
                                for c in attn_checks["float32"]))
    attn_global = dict(
        ms=cuda_ms(lambda: fa(qa, ka, va, **kw_global), 5),
        device_ms=graph_ms(lambda: fa(qa, ka, va, **kw_global), 2),
        plain_ms=cuda_ms(lambda: plain_lm_attn(qa, ka, va, **kw_global), 5),
        library_ms=cuda_ms(flex["global"]["call"], 5) if flex else None,
        bound_ms=bound(attn_bytes, 4 * hd * pairs["global"], BF16_FLOPS)[0],
        flops=4 * hd * pairs["global"],
        sdpa_causal_gqa_ms_different_function=cuda_ms(sdpa_lm, 5))
    say(json.dumps({"flash_attention_lm_global_layer": {
        "shape": [Bw, Sw, hq, hkv, hd], "mode": "causal, softcap 50, GQA 8/4, "
        "bf16, tensor-core kernel", **attn_global, "card": smi}}))
    del bhsd, qa, ka, va

    # the CUDA-core kernel at 8c's layer: one 4608-token request of gemma2
    # in fp32, local mode (window 4096, softcap 50, GQA 8/4); its launches
    # are counted in 8c.  The library column is flex_attention compiled for
    # fp32, its device time from a profiler trace
    q32, k32, v32 = (randn16(1, Sw, h, hd) for h in (hq, hkv, hkv))
    if flex:
        bm_local = create_block_mask(local_mask, None, None, Sw, Sw,
                                     device=dev)
        bhsd32 = [t.transpose(1, 2) for t in (q32, k32, v32)]

        def flex32():
            return flex_c(*bhsd32, score_mod=score_mod, block_mask=bm_local,
                          enable_gqa=True)
        t0 = time.perf_counter()
        flex32_err = max_err(flex32().transpose(1, 2),
                             plain_lm_attn(q32, k32, v32, **kw_local))
        flex32_compile_s = time.perf_counter() - t0
    n_cc = fa.launches_cuda_core
    out32 = fa(q32, k32, v32, **kw_local)
    check(fa.launches_cuda_core == n_cc + 1, "8c's fp32 layer did not take "
          "the CUDA-core kernel")
    err32 = max_err(out32, plain_lm_attn(q32, k32, v32, **kw_local))
    del out32
    record("flash_attention", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN,
           fp32_cc + attn_checks["float32"] + [dict(
               mode="gemma2_local_fp32", shape=[1, Sw, hq, hkv, hd],
               max_abs_err=err32)],
           lambda: fa(q32, k32, v32, **kw_local),
           lambda: plain_lm_attn(q32, k32, v32, **kw_local),
           flex32 if flex else None,
           4 * (2 * q32.numel() + k32.numel() + v32.numel()),
           4 * hd * pairs["local"] // Bw, [1, Sw, hq, hkv, hd], iters=3,
           phase=8,
           mode="causal, window 4096, softcap 50, GQA 8/4, fp32 (gemma2 "
                "local layer of a one-request fp32 prefill, 8c), CUDA-core "
                "kernel",
           library_call=("flex_attention, compiled for fp32, score_mod "
                         "softcap, BlockMask causal + window, enable_gqa"
                         if flex else "none (no flex_attention in this "
                         "PyTorch)"),
           library_max_abs_err=flex32_err if flex else None,
           library_first_call_s=flex32_compile_s if flex else None,
           launch_floor_ms=graph_ms(
               lambda: fa_kernel.cuda_core_empty_launch(q32, k32, v32)))
    del flex, q32, k32, v32

    # rmsnorm at the LM's norm shapes: wave A's 4 x 4608 rows of d 2304,
    # and a small ragged one; then odd widths (one element at a time), one
    # and several warps a row, strided rows and bf16 scales, drawn from
    # phase 2's generator of its own
    rms_checks = []
    for shape in ((18432, 2304), (5, 96)):
        xr, sr = randn(*shape), 0.1 * randn(shape[1])
        for dtype, tol in (("float32", TOL_RMS), ("bfloat16", TOL_RMS_BF16)):
            xd = xr.to(getattr(torch, dtype))
            err = max_err(rn_ops.rmsnorm(xd, sr), rn_ref.rmsnorm(xd, sr))
            check(err <= tol, f"rmsnorm {shape} {dtype}: max abs error "
                  f"{err:.3g} > {tol:g}")
            rms_checks.append(dict(shape=list(shape), dtype=dtype, tol=tol,
                                   max_abs_err=err))
    for d, cut in ((1, None), (100, None), (2303, None), (8192, None),
                   (2304, (3, 2307)), (2304, (8, 2312))):
        width = d if cut is None else 2320
        xr, sr = randn17(37, width), 0.1 * randn17(d)
        for dtype, tol in (("float32", TOL_RMS), ("bfloat16", TOL_RMS_BF16)):
            xd = xr.to(getattr(torch, dtype))
            xd = xd if cut is None else xd[:, cut[0]:cut[1]]
            for sdt in ("float32", "bfloat16"):
                sd = sr.to(getattr(torch, sdt))
                err = max_err(rn_ops.rmsnorm(xd, sd), rn_ref.rmsnorm(xd, sd))
                check(err <= tol, f"rmsnorm {tuple(xd.shape)} {dtype}, "
                      f"{sdt} scale, strides {xd.stride()}: max abs error "
                      f"{err:.3g} > {tol:g}")
                rms_checks.append(dict(
                    shape=list(xd.shape), stride=list(xd.stride()),
                    dtype=dtype, scale_dtype=sdt, tol=tol, max_abs_err=err,
                    vector_route=rn_kernel.vector_route(xd)))
    xr, sr = randn(18432, 2304).bfloat16(), 0.1 * randn(2304)
    w1 = (1.0 + sr).bfloat16()
    nv, warps_per_row = rn_kernel.geometry(2304, 2)
    record("rmsnorm", "cuda",
           "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
           "src/repro/kernels/rmsnorm/kernel.py:25", TOL_RMS_BF16,
           rms_checks, lambda: rn_ops.rmsnorm(xr, sr),
           lambda: rn_ref.rmsnorm(xr, sr),
           lambda: torch.nn.functional.rms_norm(xr, (2304,), w1, 1e-6),
           2 * 2 * xr.numel() + 4 * 2304, 4 * xr.numel(), [18432, 2304],
           peak=BF16_FLOPS, phase=8, dtype="bfloat16",
           library_call="F.rms_norm, weight 1 + scale",
           # rmsnorm.cu's launch: 8 warps, a two-row ring and 1 + scale
           launch_floor_ms=graph_ms(lambda: empty_launch(
               (rn_kernel.grid(xr, sr), 1), 256, 2 * nv * 256 * 16 + 4 * 8200,
               xr.get_device())),
           geometry=dict(chunks_per_lane=nv, warps_per_row=warps_per_row,
                         blocks=rn_kernel.grid(xr, sr),
                         vector_route=rn_kernel.vector_route(xr)))
    del xr

    # 8b. full-width serving in bf16: seeded random weights (the repository
    # holds no gemma2 checkpoint), two rounds of wave A (4 x 4608-token
    # prompts, past the 4096 window, 32 new tokens) and wave B (16 x 512,
    # 64 new tokens), the last-position read-out only after prefill
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = LM(lm_cfg, generator=torch.Generator(dev).manual_seed(14),
            device=dev)
    lm.eval()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    par = Parallel(prefill_last_only=True)
    rng = np.random.default_rng(14)
    waves = {"A": [rng.integers(0, lm_cfg.vocab_size, 4608) for _ in range(4)],
             "B": [rng.integers(0, lm_cfg.vocab_size, 512)
                   for _ in range(16)]}
    budget = {"A": 32, "B": 64}
    fwd, phase_s = lm.forward, {}

    def timed_forward(*args, **kwargs):        # the engine's prefill call
        n0 = (fa.launches, fa.launches_tensor_core, fa.launches_cuda_core)
        t = time.perf_counter()
        out = fwd(*args, **kwargs)
        torch.cuda.synchronize()
        phase_s["prefill"] = time.perf_counter() - t
        phase_s["prefill_launches"] = fa.launches - n0[0]
        phase_s["prefill_launches_tc"] = fa.launches_tensor_core - n0[1]
        phase_s["prefill_launches_cuda_core"] = fa.launches_cuda_core - n0[2]
        return out

    lm.forward = timed_forward
    serve_rounds, tokens = [], {}
    for rnd in (1, 2):
        eng = ServeEngine(lm_cfg, lm, max_len=4640, par=par)
        step = eng._decode

        def timed_step(*args):
            n0 = fa_ops.flash_attention.launches
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            phase_s["decode"] += time.perf_counter() - t
            phase_s["decode_launches"] += fa_ops.flash_attention.launches - n0
            return out

        eng._decode = timed_step
        for fn in fns.values():
            fn.launches = 0
        out, per_wave = {}, []
        for name in ("A", "B"):
            rids = [eng.submit(p_, max_new=budget[name])
                    for p_ in waves[name]]
            phase_s.update(decode=0.0, decode_launches=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated()
            nb, L = len(rids), len(waves[name][0])
            check(sorted(res) == rids and all(
                len(res[r]) == budget[name] for r in rids),
                f"wave {name}: results {[len(res.get(r, [])) for r in rids]}")
            check(phase_s["prefill_launches"] == lm_cfg.num_layers
                  and phase_s["prefill_launches_tc"] == lm_cfg.num_layers
                  and phase_s["prefill_launches_cuda_core"] == 0
                  and phase_s["decode_launches"] == 0,
                  f"wave {name}: {phase_s['prefill_launches']} flash launches "
                  f"in prefill ({phase_s['prefill_launches_tc']} on the "
                  f"tensor cores, {phase_s['prefill_launches_cuda_core']} on "
                  f"the CUDA cores; want {lm_cfg.num_layers}, all on the "
                  f"tensor cores), {phase_s['decode_launches']} in decode "
                  f"(want 0)")
            out.update(res)
            per_wave.append(dict(
                wave=name, requests=nb, prompt=L, new_tokens=budget[name],
                prefill_flash_launches_tensor_core=phase_s[
                    "prefill_launches_tc"],
                prefill_tokens_per_s=nb * L / phase_s["prefill"],
                decode_tokens_per_s=nb * (budget[name] - 1) / phase_s[
                    "decode"],
                prefill_s=phase_s["prefill"], decode_s=phase_s["decode"],
                wall_s=wall, peak_gib=peak / 2**30))
            w = per_wave[-1]
            say(f"[8] serve round {rnd} wave {name} ({nb} x {L}, "
                f"{budget[name]} new): prefill "
                f"{w['prefill_tokens_per_s']:.1f} tokens/s "
                f"({w['prefill_s']:.3f} s), decode "
                f"{w['decode_tokens_per_s']:.1f} tokens/s "
                f"({w['decode_s']:.3f} s), wall {wall:.3f} s, peak memory "
                f"{peak / 2**30:.2f} GiB ({smi})")
        launches = {name: fn.launches for name, fn in fns.items()}
        want_stats = dict(waves=2, prefilled=20,
                          decoded=4 * 31 + 16 * 63)
        check(eng.stats == want_stats, f"serve round {rnd}: stats "
              f"{eng.stats} != {want_stats}")
        want8 = {name: 0 for name in fns}
        want8["flash_attention"] = 2 * lm_cfg.num_layers
        check(launches == want8, f"serve round {rnd}: launches {launches} "
              f"!= expected {want8}")
        tokens[rnd] = out
        serve_rounds.append(dict(round=rnd, waves=per_wave, stats=eng.stats,
                                 launches=launches))
    lm.forward = fwd
    check(tokens[1] == tokens[2], "serve round 2 tokens differ from round "
          "1's, same weights and prompts")
    kernels["flash_attention_lm"]["launches"] = sum(
        w["prefill_flash_launches_tensor_core"]
        for w in serve_rounds[0]["waves"])
    kernels["rmsnorm"]["launches"] = serve_rounds[0]["launches"]["rmsnorm"]

    # one wave-A prefill and one decode step of it under the profiler
    toks_a = torch.as_tensor(np.stack(waves["A"]), device=dev)
    with torch.inference_mode():
        logits_a, _, caches_a = lm(toks_a, par, mode="prefill")
        full_a = eng._pad_caches(caches_a, 4, 4608)
        del caches_a
        cur_a = torch.argmax(logits_a[:, -1, :lm_cfg.vocab_size],
                             -1)[:, None].to(torch.int32)
        serve_step = make_serve_step(lm, par)
        trace_pre = device_busy(lambda: lm(toks_a, par, mode="prefill"),
                                BUILD_DIR / "lm_prefill_trace.json")
        trace_dec = device_busy(lambda: serve_step(cur_a, full_a, 4608),
                                BUILD_DIR / "lm_decode_trace.json")
    del full_a
    # the device's idle share against the untraced times of round 2's wave
    # A: its prefill, and its mean decode step
    wave_a = serve_rounds[-1]["waves"][0]
    trace_pre["device_idle_share_of_untraced_wall"] = \
        1 - trace_pre["device_busy_s"] / wave_a["prefill_s"]
    trace_dec["untraced_step_s"] = wave_a["decode_s"] / (budget["A"] - 1)
    trace_dec["device_idle_share_of_untraced_wall"] = \
        1 - trace_dec["device_busy_s"] / trace_dec["untraced_step_s"]
    say(f"[8] traced wave-A prefill: device busy "
        f"{trace_pre['device_busy_s']:.4f} s, flash attention "
        f"{trace_pre['flash_attention_device_s']:.4f} s, "
        f"{100 * trace_pre['flash_attention_share_of_busy']:.1f}% of it "
        f"({smi})")
    say(f"[8] traced wave-A decode step: device busy "
        f"{1e3 * trace_dec['device_busy_s']:.2f} ms over "
        f"{trace_dec['kernels']} kernels, untraced step "
        f"{1e3 * trace_dec['untraced_step_s']:.2f} ms; top device time (us) "
        f"{trace_dec['top_device_us'][:5]} ({smi})")
    say(json.dumps({"lm_serving": {
        "model": "gemma2-2b", "params": n_params, "dtype": "bfloat16",
        "init_s": t_init, "rounds": serve_rounds,
        "prefill_trace_wave_A": trace_pre, "decode_step_trace_wave_A":
        trace_dec, "card": smi}}))

    # 8c. kernel route against plain route at full width in fp32, on the
    # same seeded weights: one 4608-token request, 8 new tokens
    del lm, eng, step, timed_step, serve_step, fwd, timed_forward, logits_a
    torch.cuda.empty_cache()
    cfg32 = lm_cfg.replace(dtype="float32")
    lm32 = LM(cfg32, generator=torch.Generator(dev).manual_seed(14),
              device=dev)
    lm32.eval()
    prompt = waves["A"][0]
    toks1 = torch.as_tensor(prompt[None], device=dev)
    last, gen = {}, {}
    for use_kernels in (True, False):
        p32 = Parallel(use_kernels=use_kernels, prefill_last_only=True)
        fa.launches = fa.launches_short = fa.launches_tensor_core = 0
        fa.launches_cuda_core = 0
        with torch.inference_mode():
            last[use_kernels] = lm32(toks1, p32, mode="prefill")[0][0, -1]
        eng32 = ServeEngine(cfg32, lm32, max_len=4640, par=p32)
        rid = eng32.submit(prompt, max_new=8)
        gen[use_kernels] = eng32.run()[rid]
        routes = (fa.launches_short, fa.launches_tensor_core,
                  fa.launches_cuda_core)
        want = 2 * cfg32.num_layers if use_kernels else 0
        check(fa.launches == want and routes == (0, 0, want),
              f"8c use_kernels={use_kernels}: {fa.launches} flash launches, "
              f"routes (short, tensor core, CUDA core) {routes}, want {want} "
              f"on the CUDA cores")
        if use_kernels:
            kernels["flash_attention"]["launches"] = fa.launches_cuda_core
    err_lm = max_err(last[True], last[False])
    check(bool(torch.isfinite(last[True]).all())
          and float(last[False].abs().max()) > 1e-1,
          "vacuous or non-finite fp32 logits")
    say(json.dumps({"lm_kernel_vs_plain_fp32": {
        "prompt": 4608, "last_logits_max_abs_err": err_lm,
        "tol": TOL_LM_LOGITS, "max_abs_logit": float(last[False].abs().max()),
        "tokens_kernel": gen[True], "tokens_plain": gen[False],
        "tokens_agree": gen[True] == gen[False], "card": smi}}))
    check(err_lm <= TOL_LM_LOGITS, f"fp32 prefill logits kernel vs plain "
          f"{err_lm:.3g} > {TOL_LM_LOGITS:g}")
    del lm32

    say(json.dumps({"kernels": list(kernels.values())}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
