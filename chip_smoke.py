#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. card check, build of every kernel (nvcc for the CUDA source, first
     launch for the Triton kernels), with the build seconds;
  2. each kernel against its plain PyTorch version at the main path's
     shapes and at edge shapes, with kernel, plain and library times and
     the card's lower bound for the same work;
  3. the DiT at the paper preset's full width (d_model 144, 4 layers,
     4 heads, patch 4, 512-d conditioning, 16 px, batch 256) on seeded
     weights perturbed 0.05·normal: kernel path against plain path;
  4. the slice: federated data → client encodings → D_syn synthesis
     (6 clients × 10 categories × 30 samples, 50 steps, guidance 2.0,
     waves of 128), three times, with launch counts checked against the
     path each time, then a 4-step wave on the kernel path against the plain
     DiT on the same draws;
  5. one 128-row wave through ``synthesize`` under the profiler: the
     device's busy time in the trace against the wave's wall time.
The last line is the result; the line before it names the card.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TOL_CFG, TOL_ADALN, TOL_ATTN = 1e-6, 1e-5, 2e-5
TOL_DIT, TOL_E2E = 2e-5, 5e-4


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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.oscar import DataConfig, DiffusionConfig
    from repro_torch.core import oscar as core_oscar
    from repro_torch.core.oscar import client_encodings, synthesize
    from repro_torch.data.federated import make_federated_data
    from repro_torch.diffusion.dit import DiT
    from repro_torch.diffusion.sampler import sample_cfg
    from repro_torch.diffusion.schedule import make_schedule
    from repro_torch.encoders.foundation import FrozenFM
    from repro_torch.kernels.adaln_norm import ops as an_ops
    from repro_torch.kernels.adaln_norm import ref as an_ref
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.cfg_fuse import ops as cfg_ops
    from repro_torch.kernels.cfg_fuse import ref as cfg_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
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

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    fa_kernel.build()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = randn(2, 4, 8)
    an_ops.adaln_norm(small, randn(2, 8), randn(2, 8))
    cfg_ops.cfg_update(small, small, small, 2.0, 0.5, 0.7, small)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    say(f"[1] build: nvcc flash_attention {t_nvcc:.2f} s, triton adaln_norm "
        f"+ cfg_update first launch {t_triton:.2f} s")

    # -- 2. kernels against their plain versions -----------------------------
    kernels = {}

    def record(name, route, source, replaces, tol, checks, launch,
               plain, library, nbytes, flops, shape):
        err = max(c["max_abs_err"] for c in checks)
        check(err <= tol, f"{name}: max abs error {err:.3g} > {tol:g}")
        b_ms, b_by = bound(nbytes, flops)
        kernels[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=None, max_abs_err=err, tol=tol, ms=cuda_ms(launch),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else cuda_ms(library),
            device_ms=graph_ms(launch), shape=shape, checks=checks)
        k = kernels[name]
        say(f"[2] {name}: max_abs_err {err:.3g} (tol {tol:g}) over "
            f"{[c['shape'] for c in checks]}; at {shape}: {k['ms']:.4f} ms "
            f"per call, {k['device_ms']:.4f} ms on the device, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{b_ms:.4f} ms ({b_by})")

    # cfg_update: a wave's 128 x 16 x 16 x 3 and an odd total size, at the
    # first step of a 4-step (t = 999) and of a 50-step trajectory
    sched = make_schedule(1000, device=dev)
    ab = sched.alpha_bar
    steps = [(float(ab[999]), float(ab[666])), (float(ab[999]), float(ab[979]))]
    checks = []
    for shape in [(128, 16, 16, 3), (3, 5, 7)]:
        x, ec, eu, z = (randn(*shape) for _ in range(4))
        for abt, abp in steps:
            out = cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, z)
            ref = cfg_ref.cfg_update(x, ec, eu, 2.0, abt, abp, z)
            checks.append(dict(shape=list(shape), ab_t=abt, ab_prev=abp,
                               max_abs_err=max_err(out, ref)))
    x, ec, eu, z = (randn(128, 16, 16, 3) for _ in range(4))
    abt, abp = steps[1]
    n = x.numel()
    record("cfg_update", "triton", "src/repro_torch/kernels/cfg_fuse/kernel.py",
           "src/repro/kernels/cfg_fuse/kernel.py:155", TOL_CFG, checks,
           lambda: cfg_ops.cfg_update(x, ec, eu, 2.0, abt, abp, z),
           lambda: cfg_ref.cfg_update(x, ec, eu, 2.0, abt, abp, z), None,
           5 * 4 * n, 13 * n, [128, 16, 16, 3])

    # adaln_norm: the block sites (B, S, d), the final site (the strided
    # tok[:, 1:] view), the default d_model; scale/shift are strided
    # chunks of a (B, 6d) modulation, as in the DiT
    def adaln_inputs(B, N, d, drop_first):
        xx = randn(B, N + drop_first, d)[:, drop_first:]
        mod = randn(B, 6 * d)
        return xx, mod[:, d:2 * d], mod[:, :d]

    checks = []
    for B, N, d, drop in [(256, 17, 144, 0), (256, 16, 144, 1),
                          (256, 17, 128, 0)]:
        xs = adaln_inputs(B, N, d, drop)
        checks.append(dict(shape=[B, N, d], max_abs_err=max_err(
            an_ops.adaln_norm(*xs), an_ref.adaln_norm(*xs))))
    xs = adaln_inputs(256, 17, 144, 0)
    elems = 256 * 17 * 144
    record("adaln_norm", "triton",
           "src/repro_torch/kernels/adaln_norm/kernel.py",
           "src/repro/kernels/adaln_norm/kernel.py:33", TOL_ADALN, checks,
           lambda: an_ops.adaln_norm(*xs), lambda: an_ref.adaln_norm(*xs),
           None, 4 * (2 * elems + 2 * 256 * 144), 8 * elems, [256, 17, 144])

    # flash_attention: q, k, v as views of a (B, S, 3, H, hd) QKV buffer
    def qkv_views(B, S, H, hd):
        qkv = randn(B, S, 3, H, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def plain_attn(q, k, v):
        return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=False).transpose(1, 2)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    checks = []
    long_ms = {}
    for B, S, H, hd in [(256, 17, 4, 36), (256, 17, 4, 32), (4, 3137, 4, 32)]:
        q, k, v = qkv_views(B, S, H, hd)
        checks.append(dict(shape=[B, S, H, hd], max_abs_err=max_err(
            fa_ops.flash_attention(q, k, v, causal=False),
            plain_attn(q, k, v))))
        if S > 1000:
            long_ms = dict(
                shape=[B, S, H, hd],
                ms=cuda_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                          causal=False), 5),
                device_ms=graph_ms(lambda: fa_ops.flash_attention(
                    q, k, v, causal=False), 5),
                plain_ms=cuda_ms(lambda: plain_attn(q, k, v), 5),
                library_ms=cuda_ms(lambda: sdpa(q, k, v), 5),
                bound_ms=bound(4 * 4 * B * S * H * hd,
                               4 * B * H * S * S * hd)[0])
    q, k, v = qkv_views(256, 17, 4, 36)
    record("flash_attention", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN, checks,
           lambda: fa_ops.flash_attention(q, k, v, causal=False),
           lambda: plain_attn(q, k, v), lambda: sdpa(q, k, v),
           4 * 4 * 256 * 17 * 144, 4 * 256 * 4 * 17 * 17 * 36,
           [256, 17, 4, 36])
    say(f"[2] flash_attention at S=3137: {json.dumps(long_ms)}")

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
    say(f"[3] DiT call at B={B}: kernel path {dit_ms:.3f} ms per call "
        f"({dit_dev_ms:.3f} ms on the device), plain path "
        f"{dit_plain_ms:.3f} ms ({smi})")

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
           "flash_attention": fa_ops.flash_attention}
    n_rows = int(present.sum()) * k_samples
    wave_steps = math.ceil(n_rows / wave) * num_steps
    want = {"cfg_update": wave_steps,
            "flash_attention": wave_steps * dc.num_layers,
            "adaln_norm": wave_steps * (2 * dc.num_layers + 1)}
    # per-wave wall times: synthesize's calls of sample_cfg, each timed to
    # its end on the device
    wave_walls = []

    def timed_sample_cfg(*args, **kwargs):
        t = time.perf_counter()
        out = sample_cfg(*args, **kwargs)
        torch.cuda.synchronize()
        wave_walls.append(time.perf_counter() - t)
        return out

    core_oscar.sample_cfg = timed_sample_cfg
    rounds = []
    # three rounds: the first includes Triton's compiles for the tail
    # wave's shapes; the other two show the run-to-run spread
    for rnd in (1, 2, 3):
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wave_walls.clear()
        t0 = time.perf_counter()
        images, labels = synthesize(
            model, sched, enc, present, k_samples, image_size=16,
            wave_size=wave, generator=torch.Generator(dev).manual_seed(2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
        peak = torch.cuda.max_memory_allocated()
        check(launches == want, f"round {rnd}: launches {launches} != "
              f"expected {want}")
        check(n_rows == 1800, f"{n_rows} D_syn rows, expected 1800")
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
            for name, count in launches.items():
                kernels[name]["launches"] = count
            say(f"[4] D_syn: {n_rows} images {tuple(images.shape)} finite in "
                f"[-1, 1]; encodings {t_enc:.3f} s; launches {launches} == "
                f"expected")
        say(f"[4] synthesis round {rnd}: {n_rows / wall:.1f} images/s, wall "
            f"{wall:.3f} s, peak memory {peak / 2**20:.1f} MiB, {wave_steps} "
            f"wave-steps ({smi})")
    core_oscar.sample_cfg = sample_cfg
    rates = [r["images_per_s"] for r in rounds[1:]]
    say(json.dumps({"synthesis": {
        "rounds": rounds, "images": n_rows, "wave_steps": wave_steps,
        "warm_spread": (max(rates) - min(rates)) / min(rates), "card": smi}}))

    # a 4-step wave, kernel path against the plain DiT on the same draws
    # (both take cfg_update's kernel, bit-equal to its plain version at
    # this trajectory's first step in phase 2)
    rows = torch.as_tensor(enc[present][:8], device=dev)
    x_T, noise = randn(8, 16, 16, 3), randn(4, 8, 16, 16, 3)
    out, ref = (sample_cfg(m, sched, rows, num_steps=4, x_T=x_T, noise=noise)
                for m in (model, plain))
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
        return synthesize(model, sched, enc[:1], present[:1] & (
            np.arange(enc.shape[1]) < 4), 32, image_size=16, wave_size=wave,
            generator=torch.Generator(dev).manual_seed(4))

    check(one_wave()[0].shape[0] == wave, "the traced call is not one wave")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_wave()
    torch.cuda.synchronize()
    wave_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("wave"):
            one_wave()
            torch.cuda.synchronize()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = BUILD_DIR / "wave_trace.json"
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
    busy, end, by_name = 0.0, lo, {}
    for a, b, name in work:
        if b > a:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a)
    check(busy > 0, "the profiler trace holds no device work")
    traced_wall = (hi - lo) * 1e-6
    say(json.dumps({"wave_trace": {
        "rows": wave, "steps": num_steps, "kernels": len(work),
        "traced_wall_s": traced_wall, "untraced_wall_s": wave_wall,
        "device_busy_s": busy * 1e-6,
        "device_idle_share": 1 - busy * 1e-6 / traced_wall,
        "device_idle_share_of_untraced_wall": 1 - busy * 1e-6 / wave_wall,
        "top_device_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        "dit_call_ms": dit_ms, "dit_device_ms": dit_dev_ms, "card": smi}}))

    say(json.dumps({"kernels": list(kernels.values())}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
