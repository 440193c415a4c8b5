#!/usr/bin/env python3
"""Proof that the PyTorch port runs its main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. card check, build of every kernel (nvcc for the seven CUDA sources
     and the empty kernel of the launch floors, all started together),
     with the build seconds and ptxas's report (neither the tensor-core
     flash kernel nor any of the CUDA-core flash kernel's 14 instances nor
     any of cfg_fuse.cu's six nor moe.cu's three may spill), then each
     kernel's first launch;
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
     instances (registers, shared bytes, blocks an SM); the MoE's compact
     expert pass (up, down, combine) at olmoe-prefill-docs's wave beside
     ``torch._grouped_mm``;
  3. the DiT at the paper preset's full width (d_model 144, 4 layers,
     4 heads, patch 4, 512-d conditioning, 16 px, batch 256) on
     ``init_dit``'s weights from key 1 perturbed 0.05·normal: kernel path
     against plain path, and
     a call's host and device time;
     3c. the same DiT with ``bf16_act`` on the kernel path (its QKV,
     output and MLP GEMMs with bf16 operands into fp32) against the plain
     fp32 path at the reference's gate (max|Δ| < 2e-2·max(max|y|, 1)),
     its host and device time beside phase 3's, and the device time of its
     16 GEMMs in fp32 and in bf16;
     3b. a ResNet-18 classifier's forward pass and input gradient at
     B = 120 on the card against the CPU run of the same weights;
  4. the slice: federated data → client encodings → D_syn synthesis
     (6 clients × 10 categories × 30 samples, 50 steps, guidance 2.0,
     waves of at most 128: 15 waves of 120), twice from one
     threefry key, with launch counts checked against the path each time
     (every DiT attention on the short-sequence kernel); the client
     encodings computed twice here and once in a child process, their
     SHA-256 digests printed and equal; then a 4-step
     wave on the kernel path against the plain DiT on the same draws,
     each row gated by how far a probe the size of phase 3's
     kernel-vs-plain difference moves it (``row_gated``)
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
     kernel path against the plain DiT, each row gated as in phase 4
     (every rowwise update draws its noise in the kernel); the cost of the threefry draws that stay eager;
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
     the CUDA-core kernel, the call's device time and attention's share,
     and the same call with ``bf16_act`` (gated as 3c, its device time);
     7c. phase 4's uniform round with ``bf16_act``: launches against phase
     4's plan plus the bf16 GEMMs, images/s, and each D_syn row against
     phase 4's fp32 round beside how far phase 4's probe moves it (rows
     over 5e-4 and past the probe's gate counted, not gated);
  8. LM serving, gemma2-2b at full width and depth (26 layers, d 2304,
     8/4 heads of 256, vocab 256000) on ``init_lm``'s weights from key
     14, drawn on the card as the reference draws them:
     8a. flash attention's mode grid (causal, window, softcap, GQA with
         and without window, MQA, non-causal; head dims 64/128/256;
         S = 100 and 4608; fp32 through the CUDA-core kernel and bf16
         through the tensor-core kernel, bf16 also gated row by row
         relative to the row's size) and rmsnorm against their plain
         versions, and both timed at the serving shapes, beside
         ``flex_attention`` (the same function, compiled) and SDPA (a
         different one); the tensor-core kernel also at olmoe-1b-7b's
         prefill layer (4, 2048, 16/16, 128) beside ``flex_attention``
         and SDPA (there the same function);
     8b. ``ServeEngine`` in bf16, two rounds of a wave of 4 × 4608-token
         prompts (32 new tokens each) and a wave of 16 × 512 (64 each),
         with stats and flash launches checked (26 per prefill, all on
         the tensor cores, none in decode), the same tokens in both
         rounds, and one traced prefill (with the flash kernel's share of
         its device time) and decode step (its device time);
     8c. one 4608-token request in fp32 through the kernel route (the
         CUDA-core flash kernel, its launches counted) and the plain route
         on the same weights: last-position logits gated, greedy tokens
         compared;
     8d. the slice's path: olmoe-1b-7b at full width and depth (16
         layers, d 2048, 16/16 heads of 128, 64 experts top-8 of d_ff
         1024, vocab 50304) in bf16, drawn by ``init_lm`` from key 25 on
         the card (seconds, peak memory), ``ServeEngine`` serving two
         rounds of 4 × 2048 and 16 × 256 prompts (32 new tokens each; the
         same tokens both rounds, 16 flash launches a prefill, all on the
         tensor cores, none in decode; the tokens each expert received),
         a traced prefill (the MoE's and the flash kernel's shares of
         device time) and decode step (its launches), the compact MoE
         kernels' launches (one each a MoE layer pass) and one MoE layer
         compact against padded on 32,768, 8,192 and 16 tokens; then the
         same weights in fp32, one 2048-token request kernel route against
         plain route (logits gated, tokens and expert sets compared);
     8e. phi3.5-moe at full width and 4 of its 32 layers: 4 × 1024
         prompts, 16 new tokens, served twice;
     8f. granite-20b, qwen2-7b and qwen3-32b at full width and 2 layers:
         a bf16 2 × 1024 prefill and 16 decode tokens served twice, and
         the fp32 weights' kernel route against their plain route;
     8g. jamba-1.5-large at full width (d 8192, GQA 64/8 heads of 128,
         Mamba d_inner 16384, vocab 65536) with one period of its 72
         layers (7 Mamba, 1 attention, 4 MoE and 4 dense FFNs) and 8 of
         its 16 experts, bf16, ``init_lm`` from key 28 on the card: two
         rounds of 2 × 2048 and 8 × 256 prompts (16 new tokens; one
         tensor-core flash launch a prefill, 0 expert drops), the compact
         MoE kernels' launches and one MoE layer compact against padded on
         4,096 and 2 tokens, a traced decode step, and layer 0's Mamba
         mixer in fp32, card against CPU;
     8h. xlstm-125m at full width and depth (12 blocks of mLSTM and
         sLSTM), bf16, key 29: two rounds of 4 × 1024 and 16 × 256
         prompts (32 new tokens, no flash launch), a traced decode step,
         and the whole model in fp32, card against CPU (logits and 8
         greedy tokens);
     8i. hubert-xlarge at full width and depth (48 layers, d 1280, 16/16
         heads of 80), bf16, ``init_lm`` from key 30: two rounds encoding
         8 × 1024 frames with a 30% mask (frames/s, 48 tensor-core flash
         launches a forward, non-causal), a traced forward, the
         masked-prediction loss, and the kernel route against the plain
         route (2 layers in fp32 on the CUDA-core kernel's class 96, layer
         0's attention in bf16);
     8j. internvl2-1b at full width and depth (24 layers, d 896, GQA 14/2
         heads of 64), bf16, key 31: two rounds of a prefill of 8 × (256
         patches + 256 tokens) (24 tensor-core launches) and 32 greedy
         tokens of ``decode_step`` (none), a traced prefill and decode
         step, and 2 layers in fp32 kernel route against plain route;
     8k. LM training on the plain route: 3 train steps of hubert-,
         internvl- and olmoe-smoke card against CPU (metrics, and every
         parameter inside ``adamw_update_bound``), internvl2-1b at full
         width 20 AdamW steps on fp32 master weights (4 × (256 patches +
         256 Markov-corpus tokens); seconds a step, peak memory, the loss
         gated to fall, a traced step), hubert-xlarge 3 steps on 2 × 1024
         frames without and with ``remat="full"`` (the same losses; peak
         memory of a forward and backward alone);
     8l. the production training launcher and expert-parallel MoE:
         ``launch/train.py``'s run of olmoe- and xlstm-smoke (2 steps of
         2 × 16, 1×1 mesh) card against CPU (losses at 1e-5 relative,
         olmoe's MoE layers on ``moe_ep``); one ``moe_ep`` layer at
         olmoe-1b-7b's full width (64 experts top-8, fp32, 4 × 512 tokens)
         against ``moe_dense`` at capacity factor 8, and its dropped pairs
         at the config's 1.25; olmoe-1b-7b at full width with 2 of its 16
         layers through the launcher (4 × 512, 10 steps: seconds a step,
         peak memory, losses, device launches a step, dropped pairs); the
         dry run on the meta device (xlstm-125m × decode_32k and
         olmoe-1b-7b × train_4k ``ok``, hubert-xlarge × decode_32k
         ``skip``);
  9. the OSCAR pipeline at phase 4's preset and random DiT:
     ``run_oscar`` twice from one key (D_syn and the global ResNet-18
     bit-identical, synthesis and training seconds apart, training
     steps/s and peak memory, launch counts against phase 4's plan), 20
     training steps traced, three SGD steps of ``train_classifier`` on the
     card against the CPU (at the first key whose two runs keep every ReLU
     input on one side of 0), and FedAvg at participation 0.5 (10 rounds
     of 20 local steps) with its accuracy, upload (at most
     ``comm.upload_params``) and wall seconds;
 10. DM pretraining and Table I at ``benchmarks/common.py``'s paper
     preset (phase 4's data with a 7200-image pre-training pool, phase
     3's DiT, 6000 steps of 128): ``init_dit`` and a ResNet-18 from one
     key on the card equal to the CPU draws; two 50-step pretrainings
     from one key bit-identical; one training step's loss and gradients
     card against CPU; ``Experiment`` pretraining into a fresh cache
     (seconds, steps/s, peak memory, ``pretrain_dm`` traced for 20
     steps, the loss of the first and last 100 steps, gated to fall
     ``LOSS_FALL``-fold);
     a second ``Experiment`` loading the checkpoint bit for bit; one DiT
     call on the trained weights, kernel route against plain route; then
     the seven methods of Table I on the trained DM (``exp.run(m,
     rounds=20)``), each with per-client and average accuracy, upload
     (against ``comm.upload_params``), wall seconds and launch counts
     against its plan, "OSCAR avg vs best baseline" as
     ``benchmarks/table1_main.py`` prints it, and OSCAR gated above
     chance; the three DM-assisted methods draw D_syn through the
     ``Experiment``'s shared ``SynthesisService`` and its store;
 11. the D_syn front door on phase 10's trained DM, each drain's launches
     against its plan: 11.1 OSCAR and FedDISC run again, served from the
     row cache (no wave, no launch, 1800 cache hits each, Table I's
     accuracies); 11.2 a child process with a fresh ``Experiment`` on the
     same cache directory serves both from the store (no wave, no launch,
     1800 store hits each, D_syn SHA-256 and accuracies equal to Table
     I's); 11.3 phase 4's uploads at 20 then 30 samples on a fresh store
     (the second drain draws 600 rows, the first 20 of each request
     bit-equal); 11.4 phase 6's uploads streamed in through ``poll``, 10 at
     each wave boundary, against a snapshot drain, ragged (bit-identical);
     11.5 a uniform round traced and untraced (bit-identical; the chrome
     trace in ``build/service_trace.json``, validated; span counts, queue
     wait and end-to-end latency p50/p99); 11.6 fault drills: transient
     fence faults retried, a poisoned classifier closure beside a healthy
     classifier-guided tenant on a ragged service, and a truncated store
     shard quarantined and regenerated, each bit-identical to its
     fault-free drain;
 12. placed multi-host drains on phase 10's trained DM, each drain's
     launches against a plan computed from the placements it made (and
     the update kernels' launches at a non-zero ``row_offset``): 12.1
     phase 6's 60 mixed (guidance, steps) uploads unplaced, ragged and
     compacted, and over H = 1, 2, 4 simulated hosts (ragged and
     compacted; H = 2 also with ``workers=False``, bit-identical to the
     hosts' own streams; H = 1 bit-identical to the unplaced drain, which
     packs the same waves; every compacted window bit-identical to its
     replay alone through ``sample_cfg_compacted`` with the window's own
     plan), images/s and wall of every drain, each placed D_syn held row
     by row against the unplaced one (``gated12``, at most 2% of its rows
     over 2e-2); 12.2 per-host counters
     summing to the global ones in every placed drain, and a mixed H = 2
     drain launching both per-row update kernels at row_offset > 0; 12.3
     host 0 lost at wave 2 of an H = 2 drain (two replays bit-identical,
     ``failover.requeued_rows``), then every host lost
     (``AllHostsLostError``, the queue kept) and a fresh topology serving
     it; 12.4 phase 11.4's stream through two hosts' ``host_polls``; 12.5
     a ``make_serving_mesh(hosts=1, data=1, model=1)`` topology
     bit-identical to simulated H = 1; 12.6 ``Experiment(hosts=2)`` on
     phase 10's checkpoint running OSCAR, its accuracy beside Table I's;
     12.7 a traced H = 2 drain in ``build/placed_trace.json`` with two
     host tracks and the overlap of the hosts' ``device.scan`` spans; and
     the whole script's seconds.
Phases 4 and 6 run two rounds each, phase 7 two per schedule, phase 8b
two.
The last line is the result; the line before it names the card.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import zlib
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
# 8d: a (token, layer) pair whose expert set differs between the fp32
# kernel and plain routes must sit at a near-tie of the router's k-th and
# (k+1)-th probabilities: within this many fp32 ulps, or within twice how
# far the routes moved that token's probabilities
MARGIN_ULPS = 4
TOL_DIT, TOL_E2E, TOL_E2E_DEEP = 2e-5, 5e-4, 2e-2
# 3c / 7b: the DiT with bf16_act (bf16 GEMM operands, fp32 accumulation)
# against the plain fp32 path, the reference's own gate
# (tests/test_dit_fused.py::test_dit_bf16_act_opt_in): max|Δ| below this
# times max(max|y|, 1)
TOL_BF16_ACT = 2e-2
# the 4-step kernel-vs-plain gates (phases 4 and 6): a 4-step trajectory's
# first step (t = 999) divides ε̂ by √ᾱ_999 ≈ 4.9e-5, so a value it leaves
# unclipped carries the DiT's per-call difference times ~2e4·(1 + 2s) into
# its row.  Whether a row holds such a value depends on the weights and the
# draws, so each row is held by its own conditioning: a probe runs the plain
# DiT again with every output moved by ±(the DiT's kernel-vs-plain
# difference measured in phase 3), random signs and then the opposite ones,
# and a row that the larger of the two probes moved by p must agree to
# max(TOL_E2E, K_PROBE·p).  A row the probes leave alone (p ~ 1e-5) is held
# at TOL_E2E.  K_PROBE from the readings of tools/probe_calibration.py
# (PERF.md §6)
K_PROBE = 4.0
TOL_CLF = 1e-4                   # classifier, card against CPU
# phase 9: three SGD steps of ResNet-18 on 512 D_syn rows, card against
# CPU, from one init and one key.  Measured 2.4e-7 on the parameters and 0
# on the loss (H100 80GB HBM3, 700 W: fp32 sums in another order through
# three forward and backward passes; D_syn, init and batches repeat bit for
# bit, so the run repeats); a ReLU input crossing 0 between the two runs
# would move the parameters by ~1e-4, so the gate holds at the first key
# where none crosses
TOL_TRAIN = 1e-5
# phase 10: one DM training step on the plain route, card against CPU, at
# batch 128 on weights perturbed 0.05·normal: the loss (~1, fp32 means of
# 98304 squares) absolutely, and each parameter's gradient relative to its
# largest element: fp32 sums in another order through four blocks' forward
# and backward; measured 1.2e-7 on the loss and 7.3e-6 on the gradients
# (H100 80GB HBM3, 700 W); a wrong operation moves them by O(1)
TOL_DM_LOSS, TOL_DM_GRAD = 1e-5, 1e-4
# phase 10: the pretraining loss's mean over its first 100 steps against
# its last 100 must fall by at least this factor (set before the first run
# on the card; measured 2.91x, H100 80GB HBM3, 700 W: PERF.md §6)
LOSS_FALL = 2.0


# benchmarks/common.py's paper preset: 10 categories x 6 domains (one a
# client), 10 training and 8 test images per (category, domain)
PAPER_DATA = dict(num_categories=10, train_per_cat_dom=10, test_per_cat_dom=8)
SRC = Path(__file__).resolve().parent / "src"
# phase 4's child process: the paper preset's client encodings on the card
ENC_CHILD = f"""
import hashlib
from repro_torch.configs.oscar import DataConfig
from repro_torch.core.oscar import client_encodings
from repro_torch.data.federated import make_federated_data
from repro_torch.encoders.foundation import FrozenFM
data = make_federated_data(DataConfig(**{PAPER_DATA!r}))
enc, present = client_encodings(FrozenFM(), data, device="cuda")
print(hashlib.sha256(enc.tobytes() + present.tobytes()).hexdigest())
"""


# phase 10's preset: the paper's data with the DM's pre-training pool, the
# DiT pre-trained 6000 steps of 128, ResNet-18 trained 400 steps, 30
# samples a (client, category)
PAPER_POOL = dict(pretrain_pool_per_cat_dom=120)
PAPER_DM = dict(d_model=144, pretrain_steps=6000, batch_size=128)
PAPER_TOP = dict(classifier_steps=400, samples_per_category=30)
# phase 11.2's child process: a cold Experiment on phase 10's cache_dir
# runs OSCAR and FedDISC; prints, for each, the D_syn's SHA-256, the
# accuracies, the engine's waves and store hits and the kernel launches
STORE_CHILD = f"""
import hashlib, json, sys
from repro_torch.configs.oscar import DataConfig, DiffusionConfig, OscarConfig
from repro_torch.core import dm_baselines, oscar
from repro_torch.core import experiment as exp_mod
from repro_torch.kernels.adaln_norm import ops as an_ops
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
dsyn = {{}}
def kept(fn, name, pick):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        dsyn[name] = pick(out)
        return out
    return call
exp_mod.run_oscar = kept(oscar.run_oscar, "oscar", lambda o: o.syn_images)
exp_mod.run_feddisc = kept(dm_baselines.run_feddisc, "feddisc",
                           lambda o: o[3][0])
ocfg = OscarConfig(data=DataConfig(**{PAPER_DATA!r}, **{PAPER_POOL!r}),
                   diffusion=DiffusionConfig(**{PAPER_DM!r}), **{PAPER_TOP!r})
exp = exp_mod.Experiment(ocfg, verbose=False, cache_dir=sys.argv[1],
                         device="cuda")
fns = (fa_ops.flash_attention, an_ops.adaln_norm, cfg_ops.cfg_update,
       cfg_ops.cfg_update_rowwise, cfg_ops.cfg_update_mixed)
out = {{}}
for m in ("oscar", "feddisc"):
    before = exp.engine.stats
    for f in fns:
        f.launches = 0
    res = exp.run(m, rounds=20)
    after = exp.engine.stats
    data = dsyn[m].float().cpu().numpy().tobytes()
    out[m] = dict(
        avg=res["avg"], accuracies={{k: v for k, v in res.items()
                                    if k == "avg" or k.startswith("client")}},
        waves=after["waves"] - before["waves"],
        store_hits=after["store_hits"] - before["store_hits"],
        launches=sum(f.launches for f in fns),
        sha256=hashlib.sha256(data).hexdigest())
print(json.dumps(out))
"""


def enc_digest(enc, present) -> str:
    return hashlib.sha256(enc.tobytes() + present.tobytes()).hexdigest()


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


def probed(model, amplitude: float, sign: int):
    """A copy of ``model`` whose every output is moved by ±``amplitude``:
    signs drawn from a fixed seed, all of them flipped for ``sign`` -1."""
    copy_ = copy.deepcopy(model)
    gen = torch.Generator(model.null_y.device).manual_seed(5)
    forward = copy_.forward

    def moved(*args, **kwargs):
        out = forward(*args, **kwargs)
        signs = torch.randint(0, 2, out.shape, generator=gen,
                              device=out.device)
        return out + sign * amplitude * (2 * signs - 1).to(out.dtype)
    copy_.forward = moved
    return copy_


def probe_movement(run, plain, amplitude: float, ref):
    """How far each row of ``run`` moves from ``ref`` (``run(plain)``) when
    every DiT output is moved by ±``amplitude``: the larger of two probes
    with opposite signs, since the x̂₀ clip is a one-sided kink that a
    single probe may push away from while the kernel's difference crosses
    it."""
    return torch.maximum(*((run(probed(plain, amplitude, sign)) - ref)
                           .abs().flatten(1).amax(1) for sign in (1, -1)))


def row_gated(what: str, out, run, plain, amplitude: float) -> dict:
    """Hold each row of ``out`` (a kernel-path run) against ``run(plain)``
    at max(TOL_E2E, K_PROBE × the row's ``probe_movement``); returns each
    row's error, probe movement and gate."""
    ref = run(plain)
    check(float(ref.abs().max()) > 1e-3, f"vacuous {what}")
    moved = probe_movement(run, plain, amplitude, ref)
    gate = torch.clamp(K_PROBE * moved, min=TOL_E2E)
    err = (out - ref).abs().flatten(1).amax(1)
    bad = (err > gate).nonzero().flatten().tolist()
    check(not bad, f"{what}: rows {bad} kernel vs plain "
          f"{err[bad].tolist()} over their gates {gate[bad].tolist()} "
          f"(probe moved them {moved[bad].tolist()})")
    return dict(err=err.tolist(), probe=moved.tolist(), gate=gate.tolist(),
                max_err=float(err.max()), amplitude=amplitude,
                rows_over_tol=int((gate > TOL_E2E).sum()))


def rows_line(r: dict) -> str:
    return "; ".join(f"{e:.3g}/{p:.3g}" for e, p in zip(r["err"],
                                                         r["probe"]))


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


def device_busy(fn, trace_path: Path, region=()) -> dict:
    """Run ``fn`` once under the profiler; the device's busy time is the
    union of the kernel and copy intervals inside the call's span.  For
    each name in ``region`` (a name or a tuple of them), also the device
    time and the count of the kernels inside the device-side ranges of the
    ``record_function(name)`` blocks ``fn`` ran."""
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
    extra = {}
    for name in ((region,) if isinstance(region, str) else region):
        marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("name") == name
                       and e.get("cat") == "gpu_user_annotation")
        inner = [b - a for a, b, _ in work if b > a and any(
            m0 <= a and b <= m1 for m0, m1 in marks)]
        inside = sum(inner)
        extra.update({
            f"{name}_ranges": len(marks),
            f"{name}_kernels": len(inner),
            f"{name}_device_s": inside * 1e-6 if marks else None,
            f"{name}_share_of_busy": inside / busy if marks else None})
    return {**extra, "kernels": len(work), "traced_wall_s": traced_wall,
            "device_busy_s": busy * 1e-6,
            "device_idle_share": 1 - busy * 1e-6 / traced_wall,
            "flash_attention_device_s": flash * 1e-6,
            "flash_attention_share_of_busy": flash / busy,
            "top_device_us": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:10]}


# -- slice 14: the DiT's bf16_act path and the MoE / dense decoder configs ----

def bf16_act_model(model):
    """A copy of the DiT ``model`` with ``bf16_act`` on."""
    out = copy.deepcopy(model)
    out.dc = dataclasses.replace(model.dc, bf16_act=True)
    return out


def phase_3c(model, plain, xt, tt, yy, fp32: dict, smi: str):
    """3c. Phase 3's DiT, weights and inputs with ``bf16_act`` on the
    kernel path (its QKV, output and MLP GEMMs with bf16 operands into fp32
    on the tensor cores) against the plain fp32 path, at the reference's
    gate; the call's host and device time beside phase 3's fp32 call
    (``fp32``), and the device time of the four GEMMs a block at the call's
    shapes, fp32 and bf16 (casts included).  Returns (the bf16_act model,
    its largest difference from the plain path)."""
    from repro_torch.diffusion import dit as dit_mod
    model16 = bf16_act_model(model)
    L, d = model.dc.num_layers, model.dc.d_model
    errs = {}
    with torch.inference_mode():
        for y_in in (yy, None):
            n0 = dit_mod.bf16_dense.calls
            out = model16(xt, tt, y_in)
            check(dit_mod.bf16_dense.calls - n0 == 4 * L,
                  f"3c: {dit_mod.bf16_dense.calls - n0} bf16 GEMMs, want "
                  f"{4 * L}")
            ref = plain(xt, tt, y_in)
            scale = max(float(ref.abs().max()), 1.0)
            err = max_err(out, ref)
            check(out.dtype == torch.float32 and err < TOL_BF16_ACT * scale,
                  f"3c: bf16_act vs plain {err:.3g} >= {TOL_BF16_ACT:g} x "
                  f"{scale:.3f}")
            errs["given" if y_in is not None else "null"] = dict(
                max_abs_err=err, max_abs_ref=float(ref.abs().max()),
                gate=TOL_BF16_ACT * scale)
        ms = cuda_ms(lambda: model16(xt, tt, yy), 20)
        dev_ms = graph_ms(lambda: model16(xt, tt, yy), 5)
        host_ms = host_us(lambda: model16(xt, tt, yy), 100) * 1e-3
        gen = torch.Generator(xt.device).manual_seed(3)
        S = model.pos.shape[0] + 1
        h = torch.randn((xt.shape[0], S, d), generator=gen, device=xt.device)
        h4 = torch.randn((xt.shape[0], S, 4 * d), generator=gen,
                         device=xt.device)

        def gemms(dense):
            for blk in model.blocks:
                dense(blk.wqkv, h)
                dense(blk.wo, h)
                dense(blk.w_up, h)
                dense(blk.w_down, h4)

        gemm32 = graph_ms(lambda: gemms(lambda lin, v: lin(v)), 5)
        gemm16 = graph_ms(lambda: gemms(dit_mod.bf16_dense), 5)
    flops = 2 * xt.shape[0] * S * L * (d * 3 * d + d * d + 2 * d * 4 * d)
    say(json.dumps({"dit_bf16_act": {
        "batch": xt.shape[0], "tokens": S, "layers": L, "errors": errs,
        "ms_per_call": ms, "host_ms": host_ms, "device_ms": dev_ms,
        "fp32_ms_per_call": fp32["ms"], "fp32_host_ms": fp32["host_ms"],
        "fp32_device_ms": fp32["device_ms"], "gemms_device_ms_bf16": gemm16,
        "gemms_device_ms_fp32": gemm32, "gemm_flops": flops, "card": smi}}))
    say(f"[3c] DiT bf16_act B={xt.shape[0]}: vs plain fp32 max_abs_err "
        f"{max(e['max_abs_err'] for e in errs.values()):.3g} (gate "
        f"{TOL_BF16_ACT:g} x max(max|y|, 1)); {ms:.3f} ms per call, "
        f"{host_ms:.3f} ms host, {dev_ms:.3f} ms device (fp32 "
        f"{fp32['ms']:.3f} / {fp32['host_ms']:.3f} / {fp32['device_ms']:.3f});"
        f" the 16 GEMMs {gemm16:.4f} ms bf16 against {gemm32:.4f} ms fp32 on "
        f"the device ({smi})")
    return model16, max(e["max_abs_err"] for e in errs.values())


def phase_7c(run, model, model16, fp32_images, fp32_rounds, fns, want: dict,
             amplitude: float, smi: str):
    """7c. One uniform D_syn round at phase 4's preset (``run(model)``
    draws it) with ``bf16_act``: every launch against phase 4's plan
    ``want`` plus the bf16 GEMMs (four a block a DiT call, each casting its
    two operands to bf16); images/s beside phase 4's rounds; each D_syn row
    against phase 4's fp32 round beside how far the probe of phase 4's rule
    moves it (every fp32 DiT output moved by ± ``amplitude``, 3c's
    bf16-vs-fp32 difference): the rows past max(5e-4, K_PROBE·probe) and
    over 5e-4 are counted, not gated, since bf16 operands are not the fp32
    function."""
    from repro_torch.diffusion import dit as dit_mod
    fa, cfg_up = fns["flash_attention"], fns["cfg_update"]
    for fn in fns.values():
        fn.launches = 0
    keyed0, short0 = cfg_up.launches_keyed, fa.launches_short
    gemm0 = dit_mod.bf16_dense.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = run(model16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    plan = {**want, "bf16_gemms": 4 * want["flash_attention"],
            "bf16_operand_casts": 8 * want["flash_attention"]}
    got = {**launches, "bf16_gemms": dit_mod.bf16_dense.calls - gemm0,
           "bf16_operand_casts": 2 * (dit_mod.bf16_dense.calls - gemm0)}
    check(got == plan, f"7c: launches {got} != plan {plan}")
    check(cfg_up.launches_keyed - keyed0 == want["cfg_update"]
          and fa.launches_short - short0 == want["flash_attention"],
          "7c: not every update keyed or not every attention short")
    check(images.shape == fp32_images.shape
          and bool(torch.isfinite(images).all())
          and float(images.abs().max()) <= 1.0, "7c: D_syn shape or range")
    err = (images - fp32_images).abs().flatten(1).amax(1)
    moved = probe_movement(run, model, amplitude, fp32_images)
    gate = torch.clamp(K_PROBE * moved, min=TOL_E2E)
    n = images.shape[0]
    say(json.dumps({"dsyn_bf16_act": {
        "rows": n, "images_per_s": n / wall, "wall_s": wall,
        "fp32_images_per_s": [r["images_per_s"] for r in fp32_rounds],
        "launches": got, "plan": plan, "max_abs_err_vs_fp32":
        float(err.max()), "median_row_err": float(err.median()),
        "rows_over_5e-4": int((err > TOL_E2E).sum()),
        "rows_past_probe_gate": int((err > gate).sum()),
        "probe_amplitude": amplitude, "median_probe": float(moved.median()),
        "card": smi}}))
    say(f"[7c] bf16_act uniform round: {n / wall:.1f} images/s (phase 4: "
        + ", ".join(f"{r['images_per_s']:.1f}" for r in fp32_rounds)
        + f"); D_syn vs phase 4's fp32 round max {float(err.max()):.3g}, "
        f"{int((err > TOL_E2E).sum())} of {n} rows over {TOL_E2E:g}, "
        f"{int((err > gate).sum())} past max({TOL_E2E:g}, {K_PROBE:g}·probe)"
        f" (not gated) ({smi})")


class RouteLog:
    """While entered, keeps the expert indices (T, k) of every call of
    ``models/moe.py::route``, on the device, in call order; with
    ``probs``, also each call's router probabilities (T, E) in fp32."""

    def __init__(self, probs: bool = False):
        from repro_torch.models import moe as moe_mod
        self.mod, self.route, self.calls = moe_mod, moe_mod.route, []
        self.probs, self.keep_probs = [], probs

    def __enter__(self):
        def recorded(w, x_flat, m):
            out = self.route(w, x_flat, m)
            self.calls.append(out[1])
            if self.keep_probs:
                self.probs.append(torch.softmax(
                    (x_flat @ w.to(x_flat.dtype)).float(), dim=-1))
            return out
        self.mod.route = recorded
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


def moe_launches() -> dict:
    """The compact MoE pass's kernel launch counters (``kernels/moe``)."""
    from repro_torch.kernels.moe import ops as moe_ops
    return {n: getattr(moe_ops, n).launches
            for n in ("expert_up", "expert_down", "combine")}


def check_moe_launches(tag: str, before: dict, passes: int) -> dict:
    """Each compact-pass kernel launched once a MoE layer pass since
    ``before``: ``passes`` (the route calls a ``RouteLog`` saw)."""
    got = {n: v - before[n] for n, v in moe_launches().items()}
    say(f"[{tag}] compact MoE kernel launches {got} over {passes} MoE layer "
        f"passes")
    check(all(v == passes for v in got.values()) and passes > 0,
          f"{tag}: compact MoE launches {got}, want {passes} each")
    return got


def compact_vs_padded(tag: str, cfg, moe, tokens: int, dev, smi: str,
                      seed: int) -> dict:
    """One MoE layer of ``cfg`` (the served weights ``moe``) in bf16 on
    ``tokens`` random rows: the compact pass against the padded pass on one
    routing (within two bf16 ulps of the largest value), and each pass's
    milliseconds."""
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((tokens, cfg.d_model), generator=g,
                    device=dev).bfloat16()
    m = cfg.moe
    cap = moe_mod.capacity(tokens, m)
    with torch.inference_mode():
        gates, idx, _ = moe_mod.route(moe.w_router, x, m)
        args = (moe, cfg, x, 0, m.num_experts, cap, gates, idx)
        got = moe_mod.compact_pass(*args)
        want = moe_mod.padded_pass(*args)
        compact_ms = cuda_ms(lambda: moe_mod.compact_pass(*args), iters=10,
                             warmup=2)
        padded_ms = cuda_ms(lambda: moe_mod.padded_pass(*args), iters=10,
                            warmup=2)
    err, scale = max_err(got, want), float(want.float().abs().max())
    res = dict(tokens=tokens, max_abs_err=err, max_abs_y=scale,
               compact_ms=compact_ms, padded_ms=padded_ms)
    say(f"[{tag}] MoE layer on {tokens} tokens, compact pass vs padded "
        f"pass: max|Δ| {err:.3g} at max|y| {scale:.3g}; {compact_ms:.3f} ms "
        f"against {padded_ms:.3f} ms ({smi})")
    check(scale > 1e-3 and err <= 2.0 ** -6 * scale,
          f"{tag}: compact vs padded MoE pass {res}")
    return res


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` whose mixer is attention: one flash launch
    each a prefill (jamba 1 a period, xLSTM none)."""
    return sum(cfg.layer_kind(i) in ("attn", "attn_local")
               for i in range(cfg.num_layers))


def serve_twice(tag: str, cfg, lm, waves: dict, budget: dict, fns: dict,
                smi: str, log: RouteLog | None = None):
    """Two rounds of ``waves`` (name → prompts) through ``ServeEngine`` in
    the activation dtype, last-position read-out after prefill: stats,
    prefill and decode tokens/s, every flash launch on the tensor-core
    kernel (one an attention layer a prefill, none in decode), the other
    kernels not launched, and the same tokens in both rounds.  With ``log``, each
    wave's prefill also reports the tokens each expert received (summed
    over layers: min and max) and the drops against capacity.  Returns
    (the rounds, the last engine)."""
    from repro_torch.models.moe import Parallel, capacity
    from repro_torch.serve.engine import ServeEngine
    fa = fns["flash_attention"]
    par = Parallel(prefill_last_only=True)
    fwd, stat = lm.forward, {}
    n_attn = attention_layers(cfg)

    def timed_forward(*args, **kwargs):        # the engine's prefill call
        n0 = (fa.launches, fa.launches_tensor_core, fa.launches_cuda_core,
              len(log.calls) if log else 0)
        t = time.perf_counter()
        out = fwd(*args, **kwargs)
        torch.cuda.synchronize()
        stat.update(prefill=time.perf_counter() - t,
                    launches=fa.launches - n0[0],
                    tc=fa.launches_tensor_core - n0[1],
                    cc=fa.launches_cuda_core - n0[2],
                    routes=log.calls[n0[3]:] if log else [])
        return out

    lm.forward = timed_forward
    rounds, tokens = [], []
    max_len = max(len(p[0]) + budget[n] for n, p in waves.items())
    try:
        for rnd in (1, 2):
            eng = ServeEngine(cfg, lm, max_len=max_len, par=par)

            def timed_step(*args, step=eng._decode):
                n0 = fa.launches
                t = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                stat["decode"] += time.perf_counter() - t
                stat["decode_launches"] += fa.launches - n0
                return out

            eng._decode = timed_step
            for fn in fns.values():
                fn.launches = 0
            out, per_wave = {}, []
            for name, prompts in waves.items():
                rids = [eng.submit(p, max_new=budget[name]) for p in prompts]
                stat.update(decode=0.0, decode_launches=0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.perf_counter()
                res = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                peak = torch.cuda.max_memory_allocated()
                nb, L = len(prompts), len(prompts[0])
                check(sorted(res) == rids and all(
                    len(res[r]) == budget[name] for r in rids),
                    f"{tag} wave {name}: results "
                    f"{[len(res.get(r, [])) for r in rids]}")
                check(stat["launches"] == stat["tc"] == n_attn
                      and stat["cc"] == 0 and stat["decode_launches"] == 0,
                      f"{tag} wave {name}: {stat['launches']} flash launches"
                      f" in prefill ({stat['tc']} on the tensor cores, "
                      f"{stat['cc']} on the CUDA cores; want "
                      f"{n_attn}, all on the tensor cores), "
                      f"{stat['decode_launches']} in decode (want 0)")
                out.update(res)
                w = dict(wave=name, requests=nb, prompt=L,
                         new_tokens=budget[name],
                         prefill_flash_launches_tensor_core=stat["tc"],
                         prefill_tokens_per_s=nb * L / stat["prefill"],
                         decode_tokens_per_s=nb * (budget[name] - 1)
                         / stat["decode"],
                         prefill_s=stat["prefill"], decode_s=stat["decode"],
                         wall_s=wall, peak_gib=peak / 2**30,
                         peak_above_wave_start_gib=(peak - base) / 2**30)
                if stat["routes"]:
                    E = cfg.moe.num_experts
                    counts = torch.stack([torch.bincount(
                        i.flatten(), minlength=E) for i in stat["routes"]])
                    counts = counts.cpu()
                    cap = capacity(nb * L, cfg.moe)
                    w["expert_tokens"] = dict(
                        layers=counts.shape[0], capacity=cap,
                        min=int(counts.min()), max=int(counts.max()),
                        mean=nb * L * cfg.moe.top_k / E,
                        dropped=int((counts - cap).clamp(min=0).sum()))
                per_wave.append(w)
                say(f"[{tag}] serve round {rnd} wave {name} ({nb} x {L}, "
                    f"{budget[name]} new): prefill "
                    f"{w['prefill_tokens_per_s']:.1f} tokens/s "
                    f"({w['prefill_s']:.3f} s), decode "
                    f"{w['decode_tokens_per_s']:.1f} tokens/s "
                    f"({w['decode_s']:.3f} s), wall {wall:.3f} s, peak "
                    f"memory {peak / 2**30:.2f} GiB ("
                    f"{(peak - base) / 2**30:.2f} above the wave's start)"
                    + (f"; expert tokens {w['expert_tokens']}"
                       if "expert_tokens" in w else "") + f" ({smi})")
            launches = {name: fn.launches for name, fn in fns.items()}
            want = {name: 0 for name in fns}
            want["flash_attention"] = len(waves) * n_attn
            check(launches == want, f"{tag} round {rnd}: launches "
                  f"{launches} != expected {want}")
            want_stats = dict(
                waves=len(waves),
                prefilled=sum(len(p) for p in waves.values()),
                decoded=sum(len(p) * (budget[n] - 1)
                            for n, p in waves.items()))
            check(eng.stats == want_stats, f"{tag} round {rnd}: stats "
                  f"{eng.stats} != {want_stats}")
            tokens.append(out)
            rounds.append(dict(round=rnd, waves=per_wave, stats=eng.stats,
                               launches=launches))
    finally:
        del lm.forward                   # the class's method again, no cycle
    check(tokens[0] == tokens[1], f"{tag}: round 2's tokens differ from "
          "round 1's, same weights and prompts")
    return rounds, eng


def differing_expert_sets(experts: dict, probs: dict) -> list:
    """Each (layer, token) whose sorted expert set (``experts[route]``, a
    (T, k) tensor a layer) differs between the kernel route (True) and
    the plain route (False), with the plain route's margin between its
    k-th and (k+1)-th router probability (``probs[route]``, (T, E) a
    layer), in fp32 ulps of the k-th too, how far the token's router
    probabilities moved between the routes, and whether the margin is
    within ``MARGIN_ULPS`` ulps or twice that movement."""
    pairs = []
    for layer, (a, b, pk, pp) in enumerate(zip(
            experts[True], experts[False], probs[True], probs[False])):
        k = a.shape[-1]
        for r in (a != b).any(-1).nonzero().flatten().tolist():
            top = pp[r].sort(descending=True).values
            ulp = float(np.spacing(np.float32(float(top[k - 1]))))
            margin = float(top[k - 1] - top[k])
            moved = float((pk[r] - pp[r]).abs().max())
            pairs.append(dict(layer=layer, token=r, margin=margin,
                              margin_ulps=margin / ulp, moved=moved,
                              explained=margin <= max(MARGIN_ULPS * ulp,
                                                      2 * moved)))
    return pairs


def kernel_vs_plain_fp32(tag: str, cfg32, lm32, prompt, fns, smi: str,
                         new: int = 8) -> dict:
    """One request in fp32 through the kernel route (the CUDA-core flash
    kernel, one launch an attention layer a prefill) and the plain route on
    the same weights: the last-position logits gated at ``TOL_LM_LOGITS``,
    the greedy tokens compared, and for an MoE each (token, layer) pair
    whose expert set differs between the routes printed with its margin,
    the plain route's k-th router probability less its (k+1)-th: a pair
    fails unless that margin is within ``MARGIN_ULPS`` fp32 ulps of the
    k-th probability or twice how far that token's router probabilities
    moved between the routes (the routes' attention sums in other orders,
    which moves the router's inputs)."""
    from repro_torch.models.moe import Parallel
    from repro_torch.serve.engine import ServeEngine
    fa = fns["flash_attention"]
    toks = torch.as_tensor(prompt[None], device=lm32.device)
    last, gen, experts, probs = {}, {}, {}, {}
    n_attn = attention_layers(cfg32)
    for use_kernels in (True, False):
        par = Parallel(use_kernels=use_kernels, prefill_last_only=True)
        fa.launches = fa.launches_short = fa.launches_tensor_core = 0
        fa.launches_cuda_core = 0
        with RouteLog(probs=True) as log, torch.inference_mode():
            last[use_kernels] = lm32(toks, par, mode="prefill")[0][0, -1]
            experts[use_kernels] = [i.sort(-1).values for i in log.calls]
            probs[use_kernels] = log.probs
        eng = ServeEngine(cfg32, lm32, max_len=len(prompt) + new, par=par)
        rid = eng.submit(prompt, max_new=new)
        gen[use_kernels] = eng.run()[rid]
        routes = (fa.launches_short, fa.launches_tensor_core,
                  fa.launches_cuda_core)
        want = 2 * n_attn if use_kernels else 0
        check(fa.launches == want and routes == (0, 0, want),
              f"{tag} use_kernels={use_kernels}: {fa.launches} flash "
              f"launches, routes (short, tensor core, CUDA core) {routes}, "
              f"want {want} on the CUDA cores")
    err = max_err(last[True], last[False])
    pairs = differing_expert_sets(experts, probs)
    differ = len(pairs)
    for pair in pairs:
        say(f"[{tag}] expert set differs at layer {pair['layer']} token "
            f"{pair['token']}: k-th minus (k+1)-th probability "
            f"{pair['margin']:.3g} ({pair['margin_ulps']:.1f} fp32 ulps), "
            f"router probabilities moved {pair['moved']:.3g} between the "
            f"routes")
    check(all(p["explained"] for p in pairs), f"{tag}: an expert set "
          f"differs away from a near-tie: "
          f"{[p for p in pairs if not p['explained']]}")
    check(bool(torch.isfinite(last[True]).all())
          and float(last[False].abs().max()) > 1e-1,
          f"{tag}: vacuous or non-finite fp32 logits")
    out = {"prompt": len(prompt), "last_logits_max_abs_err": err,
           "tol": TOL_LM_LOGITS, "max_abs_logit":
           float(last[False].abs().max()), "tokens_kernel": gen[True],
           "tokens_plain": gen[False], "tokens_agree": gen[True] == gen[False],
           "flash_launches_cuda_core": 2 * n_attn,
           "token_layer_pairs": sum(len(e) for e in experts[True]) or None,
           "expert_sets_differing": differ if experts[True] else None,
           "differing_pairs": pairs,
           "card": smi}
    say(json.dumps({f"{tag}_kernel_vs_plain_fp32": out}))
    check(err <= TOL_LM_LOGITS, f"{tag}: fp32 prefill logits kernel vs "
          f"plain {err:.3g} > {TOL_LM_LOGITS:g}")
    return out


def drawn_on_card(tag: str, name: str, cfg, key: int, dev, smi: str):
    """``init_lm`` of ``cfg`` from ``key`` on the card: the LM, its
    parameter count and the seconds; prints them with the weights' GiB and
    the peak above what the earlier phases hold."""
    from repro_torch import prng
    from repro_torch.models.transformer import init_lm
    gc.collect()                    # earlier phases' models held in cycles
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()     # what earlier phases hold
    t0 = time.perf_counter()
    lm = init_lm(prng.PRNGKey(key), cfg, device=dev).eval()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    n_params = sum(p.numel() for p in lm.parameters())
    gib = sum(p.numel() * p.element_size() for p in lm.parameters()) / 2**30
    say(f"[{tag}] {name}: {n_params} parameters ({gib:.2f} GiB) drawn by "
        f"init_lm from key {key} on the card in {t_init:.2f} s, peak memory "
        f"{peak / 2**30:.2f} GiB above the {start / 2**30:.2f} GiB earlier "
        f"phases hold ({smi})")
    return lm, dict(params=n_params, init_s=t_init, model_gib=gib,
                    init_peak_gib_above_start=peak / 2**30,
                    allocated_at_start_gib=start / 2**30)


@contextlib.contextmanager
def annotated_moe():
    """While entered, the MoE FFN runs inside ``record_function("moe")``."""
    from repro_torch.models import moe as moe_mod
    dense = moe_mod.moe_dense

    def annotated_call(*args, **kwargs):
        with torch.profiler.record_function("moe"):
            return dense(*args, **kwargs)

    moe_mod.moe_dense = annotated_call
    try:
        yield
    finally:
        moe_mod.moe_dense = dense


def traced_decode(lm, eng, toks, par, trace_path: Path, untraced_s: float):
    """One decode step after a prefill of ``toks`` under the profiler: its
    launches and device time beside the untraced step, and the step's
    memory peak above what it starts with."""
    from repro_torch.serve.steps import make_serve_step
    B, L = toks.shape
    with torch.inference_mode():
        logits, _, caches = lm(toks, par, mode="prefill")
        full = eng._pad_caches(caches, B, L)
        del caches
        cur = torch.argmax(logits[:, -1, :lm.cfg.vocab_size],
                           -1)[:, None].to(torch.int32)
        del logits
        step = make_serve_step(lm, par)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trace = device_busy(lambda: step(cur, full, L), trace_path)
        trace["step_peak_gib_above_start"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
    trace["untraced_step_s"] = untraced_s
    trace["device_idle_share_of_untraced_step"] = \
        1 - trace["device_busy_s"] / untraced_s
    return trace


def phase_8d(dev, fns, smi: str) -> dict:
    """8d. The slice's path: olmoe-1b-7b at full width and depth (16
    layers, d 2048, 16/16 heads of 128, 64 experts top-8 of d_ff 1024,
    vocab 50304) in bf16, drawn by ``init_lm`` from key 25 on the card
    (seconds, peak memory), served by ``ServeEngine`` in two rounds of wave
    A (4 × 2048-token prompts) and wave B (16 × 256), 32 new tokens each;
    one traced wave-A prefill (the MoE's and the flash kernel's shares of
    device time) and decode step (its launches); then the same weights in
    fp32 (kernel route against plain route on one 2048-token request).
    Returns the tensor-core flash launches of round 1 and the compact MoE
    kernels' launches of both rounds."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import LM
    cfg = get_config("olmoe-1b-7b")
    lm, init = drawn_on_card("8d", "olmoe-1b-7b", cfg, 25, dev, smi)
    rng = np.random.default_rng(25)
    waves = {"A": [rng.integers(0, cfg.vocab_size, 2048) for _ in range(4)],
             "B": [rng.integers(0, cfg.vocab_size, 256) for _ in range(16)]}
    budget = {"A": 32, "B": 32}
    before = moe_launches()
    with RouteLog() as log:
        rounds, eng = serve_twice("8d", cfg, lm, waves, budget, fns, smi, log)
    launches = check_moe_launches("8d", before, len(log.calls))
    # olmoe-prefill-docs's wave (8 × 4096), wave A, a decode step of wave B
    moe_passes = [compact_vs_padded("8d", cfg, lm.layers[0].moe, n, dev, smi,
                                    25) for n in (8 * 4096, 4 * 2048, 16)]
    par = Parallel(prefill_last_only=True)
    toks = torch.as_tensor(np.stack(waves["A"]), device=dev)
    with annotated_moe(), torch.inference_mode():
        trace_pre = device_busy(lambda: lm(toks, par, mode="prefill"),
                                BUILD_DIR / "olmoe_prefill_trace.json",
                                region="moe")
    wave_a = rounds[-1]["waves"][0]
    trace_dec = traced_decode(lm, eng, toks, par,
                              BUILD_DIR / "olmoe_decode_trace.json",
                              wave_a["decode_s"] / (budget["A"] - 1))
    say(f"[8d] traced wave-A prefill: device busy "
        f"{trace_pre['device_busy_s']:.4f} s over {trace_pre['kernels']} "
        f"kernels, MoE {trace_pre['moe_device_s']} s "
        f"({trace_pre['moe_share_of_busy']} of it, "
        f"{trace_pre['moe_ranges']} ranges), flash attention "
        f"{trace_pre['flash_attention_device_s']:.4f} s "
        f"({100 * trace_pre['flash_attention_share_of_busy']:.1f}%); decode "
        f"step: {trace_dec['kernels']} launches, device busy "
        f"{1e3 * trace_dec['device_busy_s']:.2f} ms, untraced step "
        f"{1e3 * trace_dec['untraced_step_s']:.2f} ms ({smi})")
    say(json.dumps({"olmoe_serving": {
        "model": cfg.name, "dtype": "bfloat16", **init,
        "rounds": rounds, "prefill_trace_wave_A": trace_pre,
        "decode_step_trace_wave_A": trace_dec,
        "compact_moe_launches": launches, "moe_layer_passes": moe_passes,
        "card": smi}}))
    # the same weights in fp32 (bf16 values are exact in fp32)
    cfg32 = cfg.replace(dtype="float32")
    lm32 = LM(cfg32, device=dev)
    lm32.load_state_dict(lm.state_dict())
    del lm, eng
    torch.cuda.empty_cache()
    kernel_vs_plain_fp32("8d", cfg32, lm32.eval(), waves["A"][0], fns, smi)
    del lm32
    torch.cuda.empty_cache()
    return sum(w["prefill_flash_launches_tensor_core"]
               for w in rounds[0]["waves"]), launches


def phase_8e(dev, fns, smi: str) -> None:
    """8e. phi3.5-moe at full width (d 4096, 32/8 heads of 128, 16
    experts top-2 of d_ff 6400, vocab 32064) and 4 of its 32 layers (the
    32 need 84 GB in bf16), ``init_lm`` from key 26 on the card: one wave
    of 4 × 1024-token prompts, 16 new tokens, served twice."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(num_layers=4)
    t0 = time.perf_counter()
    lm = init_lm(prng.PRNGKey(26), cfg, device=dev).eval()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(26)
    waves = {"A": [rng.integers(0, cfg.vocab_size, 1024) for _ in range(4)]}
    with RouteLog() as log:
        rounds, _ = serve_twice("8e", cfg, lm, waves, {"A": 16}, fns, smi,
                                log)
    say(json.dumps({"phi35_moe_serving": {
        "model": cfg.name, "layers": cfg.num_layers, "params": sum(
            p.numel() for p in lm.parameters()), "init_s": t_init,
        "rounds": rounds, "card": smi}}))
    del lm
    torch.cuda.empty_cache()


def phase_8f(dev, fns, smi: str) -> None:
    """8f. granite-20b (MQA 48/1, qkv bias, non-gated gelu, tied
    embeddings), qwen2-7b (GQA 28/4, qkv bias, rope θ 1e6) and qwen3-32b
    (64/8 heads of 128, a q projection of 8192 > d 5120, qk-norm) at full
    width and 2 layers each: ``init_lm`` from key 27 in fp32, its weights
    cast to bf16 (``init_lm``'s bf16 values) for a 2 × 1024 prefill and
    16 decode tokens served twice; then the fp32 weights' kernel route
    against their plain route."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM, init_lm
    for name in ("granite-20b", "qwen2-7b", "qwen3-32b"):
        cfg = get_config(name).replace(num_layers=2)
        cfg32 = cfg.replace(dtype="float32")
        t0 = time.perf_counter()
        lm32 = init_lm(prng.PRNGKey(27), cfg32, device=dev).eval()
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        lm16 = LM(cfg, device=dev)
        lm16.load_state_dict(lm32.state_dict())
        rng = np.random.default_rng(27)
        waves = {"A": [rng.integers(0, cfg.vocab_size, 1024)
                       for _ in range(2)]}
        rounds, _ = serve_twice(f"8f {name}", cfg, lm16.eval(), waves,
                                {"A": 17}, fns, smi)
        say(json.dumps({"dense_serving": {
            "model": name, "layers": 2, "params": sum(
                p.numel() for p in lm16.parameters()), "init_s_fp32": t_init,
            "rounds": rounds, "card": smi}}))
        del lm16
        kernel_vs_plain_fp32(f"8f {name}", cfg32, lm32, waves["A"][0], fns,
                             smi)
        del lm32
        torch.cuda.empty_cache()


# -- slice 15: the recurrent mixers: jamba-1.5-large and xlstm-125m ----------

def phase_8g(dev, fns, smi: str) -> int:
    """8g. jamba-1.5-large at full width (d 8192, GQA 64/8 heads of 128,
    d_ff 24576, Mamba d_inner 16384, N 16, d_conv 4, vocab 65536) with
    one period of its 72 layers (7 Mamba, 1 attention; 4 MoE FFNs, 4
    dense) and 8 of its 16 experts (top-2 of d_ff 24576), bf16, drawn by
    ``init_lm`` from key 28 on the card; ``ServeEngine`` serving two
    rounds of wave A (2 × 2048-token prompts) and wave B (8 × 256), 16 new
    tokens each (one tensor-core flash launch a prefill, 0 expert drops);
    a traced decode step; then layer 0's Mamba mixer in fp32, card
    against CPU over a 256-token prefill at chunk 128 and 4 decode steps.
    (The traced prefill that split its device time into the Mamba scans,
    the MoE and flash is cut for the script's time limit: PERF.md keeps
    its numbers.)  Returns the tensor-core flash launches of round 1."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.moe import Parallel
    full_cfg = get_config("jamba-1.5-large-398b")
    cfg = full_cfg.replace(num_layers=8, moe=dataclasses.replace(
        full_cfg.moe, num_experts=8))
    lm, init = drawn_on_card("8g", "jamba-1.5-large (1 period, 8 experts)",
                             cfg, 28, dev, smi)
    rng = np.random.default_rng(28)
    waves = {"A": [rng.integers(0, cfg.vocab_size, 2048) for _ in range(2)],
             "B": [rng.integers(0, cfg.vocab_size, 256) for _ in range(8)]}
    budget = {"A": 16, "B": 16}
    before = moe_launches()
    with RouteLog() as log:
        rounds, eng = serve_twice("8g", cfg, lm, waves, budget, fns, smi, log)
    launches = check_moe_launches("8g", before, len(log.calls))
    moe_layer = next(layer.moe for layer in lm.layers
                     if getattr(layer, "moe", None) is not None)
    moe_passes = [compact_vs_padded("8g", cfg, moe_layer, n, dev, smi, 28)
                  for n in (2 * 2048, 2)]
    dropped = [w["expert_tokens"]["dropped"] for r in rounds
               for w in r["waves"]]
    check(dropped == [0] * len(dropped), f"8g: expert drops {dropped}")
    par = Parallel(prefill_last_only=True)
    toks = torch.as_tensor(np.stack(waves["A"]), device=dev)
    wave_a = rounds[-1]["waves"][0]
    trace_dec = traced_decode(lm, eng, toks, par,
                              BUILD_DIR / "jamba_decode_trace.json",
                              wave_a["decode_s"] / (budget["A"] - 1))
    say(f"[8g] traced wave-A decode step: {trace_dec['kernels']} launches, "
        f"device busy "
        f"{1e3 * trace_dec['device_busy_s']:.2f} ms, untraced step "
        f"{1e3 * trace_dec['untraced_step_s']:.2f} ms, step peak "
        f"{trace_dec['step_peak_gib_above_start']:.3f} GiB above its start "
        f"({smi})")

    # layer 0's Mamba mixer in fp32 (bf16 values are exact in fp32), card
    # against CPU: 1 x 256 tokens at chunk 128, then 4 decode steps
    cfg32 = cfg.replace(dtype="float32")
    mix = ssm_mod.Mamba(cfg32, device=dev)
    mix.load_state_dict(lm.layers[0].mixer.state_dict())
    del lm, eng
    torch.cuda.empty_cache()
    mix_cpu = copy.deepcopy(mix).cpu()
    x = torch.randn((1, 260, cfg.d_model),
                    generator=torch.Generator().manual_seed(28))
    outs = []
    for m, d in ((mix_cpu, "cpu"), (mix, dev)):
        with torch.inference_mode():
            y, state = ssm_mod.mamba_forward(m, cfg32, x[:, :256].to(d),
                                             chunk=128, return_state=True)
            got = [y]
            for t in range(256, 260):
                y, state = ssm_mod.mamba_decode(m, cfg32, x[:, t:t + 1].to(d),
                                                state)
                got.append(y)
        outs.append([g.cpu() for g in got] + [t.cpu() for t in state])
    scale = max(float(t.abs().max()) for t in outs[0][:5])
    mamba_err = max(max_err(a, b) for a, b in zip(*outs))
    mamba_tol = 1e-4 * max(1.0, scale)
    say(f"[8g] layer 0's Mamba mixer in fp32, card vs CPU (256-token "
        f"prefill at chunk 128, 4 decode steps, final state): max|Δ| "
        f"{mamba_err:.3g} at max|y| {scale:.3g}, gate {mamba_tol:.3g} "
        f"({smi})")
    check(mamba_err <= mamba_tol and scale > 1e-3,
          f"8g: fp32 Mamba card vs CPU {mamba_err:.3g} > {mamba_tol:.3g} "
          f"(max|y| {scale:.3g})")
    del mix, mix_cpu
    torch.cuda.empty_cache()
    say(json.dumps({"jamba_serving": {
        "model": cfg.name, "layers": cfg.num_layers,
        "experts": cfg.moe.num_experts, "dtype": "bfloat16", **init,
        "rounds": rounds, "decode_step_trace_wave_A": trace_dec,
        "compact_moe_launches": launches, "moe_layer_passes": moe_passes,
        "mamba_fp32_card_vs_cpu": dict(max_abs_err=mamba_err,
                                       max_abs_y=scale, tol=mamba_tol),
        "card": smi}}))
    return sum(w["prefill_flash_launches_tensor_core"]
               for w in rounds[0]["waves"])


def phase_8h(dev, fns, smi: str) -> None:
    """8h. xlstm-125m at full width and depth (12 blocks alternating mLSTM
    and sLSTM, d 768, 4 heads, vocab 50304, tied embeddings) in bf16,
    drawn by ``init_lm`` from key 29 on the card; ``ServeEngine`` serving
    two rounds of wave A (4 × 1024-token prompts) and wave B (16 × 256),
    32 new tokens each (no flash launch: no attention); a traced decode
    step; then the whole model in fp32, card against CPU, at 16- and
    512-token prompts (last-position logits and layer 0's output), and 8
    greedy tokens after the 16-token prompt.  (The traced prefill that
    counted the sLSTM loop's launches is cut for the script's time limit:
    PERF.md keeps its numbers.)"""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("xlstm-125m")
    lm, init = drawn_on_card("8h", "xlstm-125m", cfg, 29, dev, smi)
    rng = np.random.default_rng(29)
    waves = {"A": [rng.integers(0, cfg.vocab_size, 1024) for _ in range(4)],
             "B": [rng.integers(0, cfg.vocab_size, 256) for _ in range(16)]}
    budget = {"A": 32, "B": 32}
    rounds, eng = serve_twice("8h", cfg, lm, waves, budget, fns, smi)
    par = Parallel(prefill_last_only=True)
    toks = torch.as_tensor(np.stack(waves["B"]), device=dev)
    wave_b = rounds[-1]["waves"][1]
    trace_dec = traced_decode(lm, eng, toks, par,
                              BUILD_DIR / "xlstm_decode_trace.json",
                              wave_b["decode_s"] / (budget["B"] - 1))
    say(f"[8h] traced wave-B decode step: {trace_dec['kernels']} launches, device busy "
        f"{1e3 * trace_dec['device_busy_s']:.2f} ms, untraced step "
        f"{1e3 * trace_dec['untraced_step_s']:.2f} ms ({smi})")

    # the whole model in fp32 (bf16 values are exact in fp32), card
    # against CPU.  At full width the sLSTM's recurrent weights, drawn at
    # the reference's std 1/√H = 0.5, make the function chaotic: a one-ulp
    # change of the weights moves the reference's own logits by O(1) within
    # ~128 positions (tools/xlstm_chaos.py, PERF.md §6).  Gated: the
    # residual after layer 0 (an mLSTM, before any sLSTM) at 1e-4 of its
    # size at 16 and 512 tokens; a 16-token prompt's last-position logits
    # at TOL_LM_LOGITS and its 8 greedy tokens equal.  The 512-token
    # prompt's logits are printed, not gated
    cfg32 = cfg.replace(dtype="float32")
    state = lm.state_dict()
    del lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    lms = {}
    for d in ("cpu", dev):
        lms[d] = LM(cfg32, device=d)
        lms[d].load_state_dict(state)
        lms[d].eval()
    del state
    fp32 = {}
    for L in (16, 512):
        prompt = waves["A"][0][:L]
        last, first = {}, {}
        for name, m in lms.items():
            hook = m.layers[1].norm1.register_forward_pre_hook(
                lambda mod, args, name=name: first.__setitem__(
                    name, args[0].float().cpu()))
            with torch.inference_mode():
                last[name] = m(torch.as_tensor(prompt[None], device=m.device),
                               Parallel(prefill_last_only=True),
                               mode="prefill")[0][0, -1].float().cpu()
            hook.remove()
        fp32[L] = dict(
            last_logits_max_abs_err=max_err(last[dev], last["cpu"]),
            max_abs_logit=float(last["cpu"].abs().max()),
            layer0_max_abs_err=max_err(first[dev], first["cpu"]),
            layer0_max_abs=float(first["cpu"].abs().max()))
    prompt, gen = waves["A"][0][:16], {}
    for name in ("cpu", dev):
        eng32 = ServeEngine(cfg32, lms[name], max_len=24,
                            par=Parallel(prefill_last_only=True))
        rid = eng32.submit(prompt, max_new=8)
        gen[name] = eng32.run()[rid]
    fp32[16].update(tokens_card=gen[dev], tokens_cpu=gen["cpu"],
                    tokens_agree=gen[dev] == gen["cpu"])
    del lms, eng32
    say(json.dumps({"xlstm_fp32_card_vs_cpu": {
        "tol": TOL_LM_LOGITS, "gated_logits": "prompt_16",
        **{f"prompt_{L}": v for L, v in fp32.items()}, "card": smi}}))
    for L, r in fp32.items():
        check(math.isfinite(r["last_logits_max_abs_err"])
              and r["max_abs_logit"] > 1e-1, f"8h: vacuous or non-finite "
              f"fp32 logits at {L} tokens")
        check(r["layer0_max_abs_err"] <= 1e-4 * max(1.0, r["layer0_max_abs"]),
              f"8h: fp32 layer 0 (mLSTM) card vs CPU "
              f"{r['layer0_max_abs_err']:.3g} at {L} tokens")
    check(fp32[16]["last_logits_max_abs_err"] <= TOL_LM_LOGITS
          and fp32[16]["tokens_agree"], f"8h: fp32 16-token prompt card vs "
          f"CPU: logits {fp32[16]['last_logits_max_abs_err']:.3g}, tokens "
          f"{fp32[16]['tokens_card']} / {fp32[16]['tokens_cpu']}")
    torch.cuda.empty_cache()
    say(json.dumps({"xlstm_serving": {
        "model": cfg.name, "layers": cfg.num_layers, "dtype": "bfloat16",
        **init, "rounds": rounds, "decode_step_trace_wave_B": trace_dec,
        "card": smi}}))


# -- slice 16: the frontends, the encoder head and LM training ---------------

def lm_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """The reference's batch of ``B`` sequences of ``S`` positions for
    ``cfg``'s frontend, seeded: tokens; ``num_prefix_tokens`` normal patch
    embeddings and the rest tokens; or normal frame embeddings (1024 frames
    are 20 s at HuBERT's 50 Hz) with a 30% mask and k-means labels."""
    g = torch.Generator(dev).manual_seed(seed)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn((B, S, cfg.frontend_dim), generator=g,
                                      device=dev),
                "mask": torch.rand((B, S), generator=g, device=dev) < 0.3,
                "labels": tokens(B, S)}
    P = cfg.num_prefix_tokens
    batch = {"tokens": tokens(B, S - P)}
    if P:
        batch["patches"] = torch.randn((B, P, cfg.frontend_dim),
                                       generator=g, device=dev)
    return batch


def first_layers(lm, cfg, n: int, dtype: str, dev):
    """An LM of ``cfg`` cut to its first ``n`` layers in ``dtype`` on
    ``lm``'s weights (bf16 values are exact in fp32)."""
    from repro_torch.models.transformer import LM
    cut = LM(cfg.replace(num_layers=n, dtype=dtype), device=dev)
    state = lm.state_dict()
    cut.load_state_dict({k: state[k] for k in cut.state_dict()})
    return cut.eval()


def routes_of(fa) -> tuple:
    return (fa.launches, fa.launches_tensor_core, fa.launches_cuda_core,
            fa.launches_short)


def phase_8i(dev, fns, smi: str) -> dict:
    """8i. hubert-xlarge at full width and depth (48 layers, d 1280, 16/16
    heads of 80, d_ff 5120 gelu, 504 k-means targets), bf16, drawn by
    ``init_lm`` from key 30 on the card: two rounds encoding 8 clips of
    1024 frames with a seeded 30% mask (frames/s; 48 tensor-core flash
    launches a forward, non-causal), a traced forward (flash's share of
    device time), the masked-prediction ``loss_fn``; then the kernel route
    against the plain route: the first 2 layers in fp32 (the CUDA-core
    kernel, class 96) on 2 clips at ``TOL_LM_LOGITS``, and layer 0 in
    bf16, its attention output within the bf16 gates.  Returns the
    kernel rows' launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import loss_fn
    fa = fns["flash_attention"]
    cfg = get_config("hubert-xlarge")
    lm, init = drawn_on_card("8i", "hubert-xlarge", cfg, 30, dev, smi)
    batch = lm_batch(cfg, 8, 1024, 30, dev)
    rounds = []
    for fn in fns.values():
        fn.launches = 0
    fa.launches_tensor_core = fa.launches_cuda_core = fa.launches_short = 0
    for rnd in (1, 2):
        n0 = routes_of(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, aux = lm(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = [a - b for a, b in zip(routes_of(fa), n0)]
        check(d == [cfg.num_layers, cfg.num_layers, 0, 0],
              f"8i round {rnd}: flash launches (all, tensor core, CUDA "
              f"core, short) {d}, want {cfg.num_layers} on the tensor cores")
        check(tuple(logits.shape) == (*batch["mask"].shape,
                                      cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"8i: logits {tuple(logits.shape)} not finite or misshapen")
        rounds.append(dict(round=rnd, s=wall, frames_per_s=8 * 1024 / wall,
                           flash_launches_tensor_core=d[1]))
        say(f"[8i] round {rnd}: 8 x 1024 frames in {wall:.4f} s, "
            f"{8 * 1024 / wall:.1f} frames/s, {d[1]} tensor-core flash "
            f"launches ({smi})")
        del logits
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {name: 0 for name in fns}
    want["flash_attention"] = 2 * cfg.num_layers
    check(launches == want, f"8i: launches {launches} != {want}")
    with torch.inference_mode():
        loss, metrics = loss_fn(lm, batch, Parallel())
        trace = device_busy(lambda: lm(batch),
                            BUILD_DIR / "hubert_encode_trace.json")
    check(math.isfinite(float(loss)) and float(metrics["aux"]) == 0.0,
          f"8i: masked-prediction loss {float(loss)}")
    say(f"[8i] masked-prediction loss {float(loss):.4f} (ln 504 = "
        f"{math.log(504):.4f}); traced forward: device busy "
        f"{trace['device_busy_s']:.4f} s over {trace['kernels']} kernels "
        f"({100 * trace['device_idle_share']:.1f}% idle), flash attention "
        f"{trace['flash_attention_device_s']:.4f} s "
        f"({100 * trace['flash_attention_share_of_busy']:.2f}%) ({smi})")

    # the kernel route against the plain route: 2 layers in fp32 on 2 clips
    # (the CUDA-core kernel, class 96, non-causal), and layer 0 in bf16,
    # its attention output (the input of wo) within the bf16 gates
    small = {k: v[:2] for k, v in batch.items()}
    lm32 = first_layers(lm, cfg, 2, "float32", dev)
    lm16 = first_layers(lm, cfg, 1, "bfloat16", dev)
    del lm
    torch.cuda.empty_cache()
    out, attn, cc = {}, {}, {}
    for use_kernels in (True, False):
        par = Parallel(use_kernels=use_kernels)
        n0 = routes_of(fa)
        hook = lm16.layers[0].mixer.wo.register_forward_pre_hook(
            lambda mod, args, u=use_kernels: attn.__setitem__(u, args[0]))
        with torch.inference_mode():
            out[use_kernels] = lm32(small, par)[0]
            lm16(small, par)
        hook.remove()
        cc[use_kernels] = [a - b for a, b in zip(routes_of(fa), n0)]
    check(cc[True] == [3, 1, 2, 0] and cc[False] == [0, 0, 0, 0],
          f"8i: kernel-route launches {cc}, want 2 on the CUDA cores (fp32) "
          f"and 1 on the tensor cores (bf16); none on the plain route")
    err32 = max_err(out[True], out[False])
    a16, r16 = (attn[True].float(), attn[False].float())
    err16 = max_err(a16, r16)
    rel16 = row_rel_err(a16, r16)
    res = dict(last_logits_max_abs_err=err32, tol=TOL_LM_LOGITS,
               max_abs_logit=float(out[False].abs().max()),
               bf16_layer0_attention_max_abs_err=err16,
               bf16_layer0_attention_max_row_rel_err=rel16,
               bf16_tol=TOL_ATTN_BF16, bf16_row_tol=TOL_ATTN_BF16_ROW)
    say(json.dumps({"hubert_kernel_vs_plain": {**res, "card": smi}}))
    check(err32 <= TOL_LM_LOGITS and res["max_abs_logit"] > 1e-1
          and bool(torch.isfinite(out[True]).all()),
          f"8i: fp32 logits kernel vs plain {err32:.3g} > {TOL_LM_LOGITS:g}")
    check(err16 <= TOL_ATTN_BF16 and rel16 <= TOL_ATTN_BF16_ROW,
          f"8i: bf16 layer-0 attention kernel vs plain {err16:.3g}, "
          f"row-relative {rel16:.3g}")
    del lm32, lm16, out, attn, batch, small
    torch.cuda.empty_cache()
    say(json.dumps({"hubert_encoding": {
        "model": cfg.name, "dtype": "bfloat16", **init, "batch": [8, 1024],
        "rounds": rounds, "loss": float(loss), "trace": trace,
        "kernel_vs_plain": res, "card": smi}}))
    return {"flash_attention_lm_hubert": rounds[0][
                "flash_launches_tensor_core"],
            "flash_attention_fp32_hd80": cc[True][2]}


def phase_8j(dev, fns, smi: str) -> int:
    """8j. internvl2-1b at full width and depth (24 layers, d 896, GQA 14/2
    heads of 64, qkv bias, tied embeddings, vocab 151655), bf16, drawn by
    ``init_lm`` from key 31 on the card: two rounds of a prefill of 8 ×
    (256 patches + 256 tokens) (24 tensor-core flash launches, causal) and
    32 greedy tokens of ``decode_step`` (no flash launch), prefill and
    decode tokens/s, a traced decode step (its launches); then the first 2
    layers in fp32, kernel route (the CUDA-core kernel, GQA 7) against
    plain route on one image and 256 tokens at ``TOL_LM_LOGITS``.  Returns
    the tensor-core flash launches of round 1."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.attention import KVCache
    from repro_torch.models.moe import Parallel
    from repro_torch.serve.steps import make_serve_step
    fa = fns["flash_attention"]
    cfg = get_config("internvl2-1b")
    lm, init = drawn_on_card("8j", "internvl2-1b", cfg, 31, dev, smi)
    batch = lm_batch(cfg, 8, 512, 31, dev)
    B, L, new = 8, cfg.num_prefix_tokens + batch["tokens"].shape[1], 32
    par = Parallel(prefill_last_only=True)
    step = make_serve_step(lm, par)
    rounds, tokens = [], []
    for fn in fns.values():
        fn.launches = 0
    fa.launches_tensor_core = fa.launches_cuda_core = fa.launches_short = 0
    for rnd in (1, 2):
        n0 = routes_of(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _, caches = lm(batch, par, mode="prefill")
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        d_pre = [a - b for a, b in zip(routes_of(fa), n0)]
        with torch.inference_mode():
            full = lm.init_caches(B, L + new)
            for f, c in zip(full, caches):
                f.k[:, :L], f.v[:, :L] = c.k, c.v
            del caches
            cur = torch.argmax(logits[:, -1, :cfg.vocab_size],
                               -1)[:, None].to(torch.int32)
        out = [cur]
        n0 = routes_of(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new - 1):
            cur, _, full = step(cur, full, L + i)
            out.append(cur)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        d_dec = [a - b for a, b in zip(routes_of(fa), n0)]
        check(d_pre == [cfg.num_layers, cfg.num_layers, 0, 0]
              and d_dec == [0, 0, 0, 0], f"8j round {rnd}: flash launches "
              f"in prefill {d_pre} (want {cfg.num_layers} on the tensor "
              f"cores), in decode {d_dec} (want none)")
        tokens.append(torch.cat(out, 1).cpu())
        rounds.append(dict(round=rnd, prefill_s=t_pre,
                           prefill_tokens_per_s=B * L / t_pre,
                           decode_s=t_dec,
                           decode_tokens_per_s=B * (new - 1) / t_dec,
                           flash_launches_tensor_core=d_pre[1]))
        say(f"[8j] round {rnd}: prefill 8 x (256 patches + 256 tokens) "
            f"{B * L / t_pre:.1f} tokens/s ({t_pre:.4f} s), decode "
            f"{B * (new - 1) / t_dec:.1f} tokens/s ({t_dec:.4f} s for "
            f"{new - 1} steps), {d_pre[1]} tensor-core flash launches "
            f"({smi})")
    check(torch.equal(tokens[0], tokens[1]), "8j: round 2's tokens differ "
          "from round 1's, same weights and batch")
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {name: 0 for name in fns}
    want["flash_attention"] = 2 * cfg.num_layers
    check(launches == want, f"8j: launches {launches} != {want}")
    with torch.inference_mode():
        trace = device_busy(lambda: step(cur, full, L + new - 1),
                            BUILD_DIR / "internvl_decode_trace.json")
        trace_pre = device_busy(lambda: lm(batch, par, mode="prefill"),
                                BUILD_DIR / "internvl_prefill_trace.json")
    trace["untraced_step_s"] = rounds[-1]["decode_s"] / (new - 1)
    trace_pre["device_idle_share_of_untraced_wall"] = \
        1 - trace_pre["device_busy_s"] / rounds[-1]["prefill_s"]
    say(f"[8j] traced prefill: device busy {trace_pre['device_busy_s']:.4f} "
        f"s over {trace_pre['kernels']} kernels "
        f"({100 * trace_pre['device_idle_share']:.1f}% idle), flash "
        f"attention {trace_pre['flash_attention_device_s']:.4f} s "
        f"({100 * trace_pre['flash_attention_share_of_busy']:.2f}%); "
        f"decode step: {trace['kernels']} launches, device busy "
        f"{1e3 * trace['device_busy_s']:.2f} ms, untraced step "
        f"{1e3 * trace['untraced_step_s']:.2f} ms ({smi})")
    del full, logits

    # 2 layers in fp32, kernel route against plain route on one image
    lm32 = first_layers(lm, cfg, 2, "float32", dev)
    del lm, step
    torch.cuda.empty_cache()
    one = {k: v[:1] for k, v in batch.items()}
    last, cc = {}, {}
    for use_kernels in (True, False):
        n0 = routes_of(fa)
        with torch.inference_mode():
            last[use_kernels] = lm32(one, Parallel(
                use_kernels=use_kernels, prefill_last_only=True),
                mode="prefill")[0][0, -1]
        cc[use_kernels] = [a - b for a, b in zip(routes_of(fa), n0)]
    check(cc[True] == [2, 0, 2, 0] and cc[False] == [0, 0, 0, 0],
          f"8j: fp32 launches {cc}, want 2 on the CUDA cores")
    err = max_err(last[True], last[False])
    res = dict(last_logits_max_abs_err=err, tol=TOL_LM_LOGITS,
               max_abs_logit=float(last[False].abs().max()))
    check(err <= TOL_LM_LOGITS and res["max_abs_logit"] > 1e-1
          and bool(torch.isfinite(last[True]).all()),
          f"8j: fp32 logits kernel vs plain {err:.3g} > {TOL_LM_LOGITS:g}")
    del lm32
    torch.cuda.empty_cache()
    say(json.dumps({"internvl_serving": {
        "model": cfg.name, "dtype": "bfloat16", **init,
        "batch": [8, 256, 256], "new_tokens": new, "rounds": rounds,
        "prefill_trace": trace_pre, "decode_step_trace": trace,
        "kernel_vs_plain_fp32": res,
        "card": smi}}))
    return rounds[0]["flash_launches_tensor_core"]


def train_card_vs_cpu(name: str, dev, smi: str) -> dict:
    """Three ``make_train_step`` steps of ``name``'s smoke config on the
    card and on the CPU from one set of fp32 weights (``init_train_state``
    from key 32 on the CPU): the loss and metrics within ``TOL_TRAIN``
    relative, each parameter within ``TOL_TRAIN`` of its leaf's largest
    element plus ``adamw_update_bound`` of the CPU run's moments (AdamW
    normalises a gradient that is rounding noise to ~lr on either
    device)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.models.transformer import LM
    from repro_torch.optim.optimizers import adamw_update_bound, init_adamw
    from repro_torch.train.steps import (TrainState, init_train_state,
                                         make_train_step)
    cfg = smoke_config(get_config(name))
    cpu = init_train_state(prng.PRNGKey(32), cfg, device="cpu")
    lm = LM(cfg, device=dev, param_dtype=torch.float32)
    lm.load_state_dict(cpu.params.state_dict())
    card = TrainState(lm, init_adamw({k: v.detach()
                                      for k, v in lm.named_parameters()}))
    step = make_train_step(cfg)
    drift = {k: 0.0 for k in cpu.opt.mu}
    metric_err = param_excess = plain_rel = 0.0
    for i in range(3):
        batch = lm_batch(cfg, 2, 24, 32 + i, "cpu")
        prev = cpu.opt
        cpu, m_cpu = step(cpu, batch)
        card, m_card = step(card, {k: v.to(dev) for k, v in batch.items()})
        for k in ("loss", "ce", "aux", "grad_norm"):
            a, b = float(m_card[k]), float(m_cpu[k])
            metric_err = max(metric_err, abs(a - b) / max(abs(b), 1.0))
        bound = adamw_update_bound(prev, cpu.opt, lr=3e-4, rel=TOL_TRAIN)
        want, got = cpu.params.state_dict(), card.params.state_dict()
        for k, w in want.items():
            drift[k] = drift[k] + bound[k]
            err = (got[k].cpu() - w).abs()
            scale = float(w.abs().max())
            plain_rel = max(plain_rel, float(err.max()) / scale)
            param_excess = max(param_excess, float(
                (err - TOL_TRAIN * scale - drift[k]).max()))
    res = dict(config=cfg.name, loss=float(m_cpu["loss"]),
               aux=float(m_cpu["aux"]), metrics_max_rel_err=metric_err,
               params_max_rel_err=plain_rel,
               params_excess_over_gate=param_excess, tol=TOL_TRAIN)
    say(f"[8k] {cfg.name}: 3 train steps card vs CPU: metrics "
        f"{metric_err:.3g} relative, parameters {plain_rel:.3g} of their "
        f"leaf's largest, excess over the gate {param_excess:.3g} ({smi})")
    check(metric_err <= TOL_TRAIN and param_excess <= 0.0,
          f"8k: {cfg.name} train steps card vs CPU: {res}")
    return res


def phase_8k(dev, fns, smi: str) -> None:
    """8k. LM training on the card (the plain route: no kernel launch).
    Card against CPU: hubert-, internvl- and olmoe-smoke (the MoE aux
    term), 3 steps each (``train_card_vs_cpu``).  At full width and depth:
    internvl2-1b from ``init_train_state`` (fp32 master weights, key 32),
    20 AdamW steps on 4 × (256 patches + 256 tokens), the tokens from
    ``make_lm_dataset`` (a Markov corpus, 20480 tokens) and the patches
    seeded normal: seconds a step, peak memory, the loss of every step
    (the last gated below the first); hubert-xlarge 3 steps on 2 × 1024
    frames with ``remat="full"`` (its config's) and without: seconds a
    step and peak memory of each."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data.lm import make_lm_dataset
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.steps import init_train_state, make_train_step
    for fn in fns.values():
        fn.launches = 0
    smoke = [train_card_vs_cpu(name, dev, smi) for name in
             ("hubert-xlarge", "internvl2-1b", "olmoe-1b-7b")]
    check(smoke[2]["aux"] > 0, "8k: olmoe-smoke's aux term is 0")

    def trained(cfg, batches, tag, trace_path=None):
        """Steps of ``cfg`` from key 32 over ``batches``: the losses,
        seconds a step after the first and the first's, the peak above the
        start and the GiB of the state (weights and two moments); then the
        peak of one forward and backward alone above the state, and, with
        ``trace_path``, one more step traced."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        state = init_train_state(prng.PRNGKey(32), cfg, device=dev)
        step = make_train_step(cfg)
        losses, secs = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        losses = torch.stack(losses).tolist()
        out = dict(steps=len(batches), losses=losses,
                   first_step_s=secs[0],
                   s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
                   peak_gib_above_start=(torch.cuda.max_memory_allocated()
                                         - start) / 2**30,
                   state_gib=3 * sum(p.numel() for p in
                                     state.params.parameters()) * 4 / 2**30)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            loss, _ = loss_fn(state.params, batches[-1],
                              Parallel(use_kernels=False))
            grads = torch.autograd.grad(loss, list(
                state.params.parameters()), allow_unused=True)
        out["forward_backward_peak_gib_above_state"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        del loss, grads
        if trace_path is not None:
            out["trace"] = device_busy(lambda: step(state, batches[-1]),
                                       trace_path)
        check(all(math.isfinite(x) for x in losses),
              f"8k: {tag} losses {losses}")
        say(f"[8k] {tag}: {len(batches)} steps, {out['s_per_step']:.4f} s a "
            f"step after a first of {secs[0]:.3f} s, peak "
            f"{out['peak_gib_above_start']:.2f} GiB (weights and two "
            f"moments {out['state_gib']:.2f} GiB; a forward and backward "
            f"alone {out['forward_backward_peak_gib_above_state']:.2f} GiB "
            f"above them), loss "
            f"{', '.join(f'{x:.4f}' for x in losses)}"
            + (f"; traced step: device busy "
               f"{out['trace']['device_busy_s']:.4f} s over "
               f"{out['trace']['kernels']} kernels "
               f"({100 * out['trace']['device_idle_share']:.1f}% idle)"
               if trace_path else "") + f" ({smi})")
        del state, step
        return out

    cfg = get_config("internvl2-1b")
    t0 = time.perf_counter()
    data = make_lm_dataset(cfg.vocab_size, seq_len=256, n_tokens=20 * 4 * 256,
                           kind="markov", seed=32)
    data_s = time.perf_counter() - t0
    g = torch.Generator(dev).manual_seed(32)
    batches = [{"tokens": torch.as_tensor(b["tokens"], device=dev),
                "patches": torch.randn((4, cfg.num_prefix_tokens,
                                        cfg.frontend_dim), generator=g,
                                       device=dev)}
               for b in data.batches(4, seed=32, epochs=1)]
    check(len(batches) == 20, f"8k: {len(batches)} batches of internvl data")
    vlm = trained(cfg, batches, "internvl2-1b full width, fp32 master",
                  BUILD_DIR / "internvl_train_step_trace.json")
    check(vlm["losses"][-1] < vlm["losses"][0], f"8k: internvl2-1b's loss "
          f"did not fall over 20 steps: {vlm['losses']}")
    del batches
    hub = {}
    full = get_config("hubert-xlarge")
    frames = [lm_batch(full, 2, 1024, 33 + i, dev) for i in range(3)]
    for remat in ("none", "full"):
        hub[remat] = trained(full.replace(remat=remat), frames,
                             f"hubert-xlarge full width, remat {remat}")
    check(hub["full"]["losses"] == hub["none"]["losses"],
          f"8k: hubert-xlarge's losses with remat {hub['full']['losses']} "
          f"differ from those without {hub['none']['losses']}")
    launches = {name: fn.launches for name, fn in fns.items()}
    check(launches == {name: 0 for name in fns},
          f"8k: training launched kernels {launches}")
    say(json.dumps({"lm_training": {
        "card_vs_cpu_smoke": smoke,
        "internvl2_1b": dict(batch=[4, 256, 256], data_s=data_s, **vlm),
        "hubert_xlarge": dict(batch=[2, 1024], **hub), "card": smi}}))


# -- the training launcher, expert-parallel MoE and the dry run -------------

def phase_8l(dev, fns, smi: str) -> None:
    """8l. ``launch/train.py`` and ``moe_ep`` on the card, and the dry run
    on the meta device.  Training runs the plain route: no kernel of the
    port launches (checked)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import smoke_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import draw_batch, train
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe import Parallel
    from repro_torch import prng
    from repro_torch.train.steps import make_train_step
    for fn in fns.values():
        fn.launches = 0
    quiet = lambda *a: None

    # 8l.1 the launcher, card against CPU
    smoke = {}
    for name in ("olmoe-1b-7b", "xlstm-125m"):
        cfg = smoke_config(get_config(name))
        calls = moe_mod.moe_ep.calls
        runs = {d: train(cfg, steps=2, batch=2, seq=16, device=d, log=quiet)
                for d in ("cpu", dev)}
        ep = moe_mod.moe_ep.calls - calls
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            runs[dev]["losses"], runs["cpu"]["losses"]))
        smoke[cfg.name] = dict(losses_card=runs[dev]["losses"],
                               losses_cpu=runs["cpu"]["losses"],
                               max_rel_err=rel, moe_ep_calls=ep)
        say(f"[8l.1] {cfg.name}: launcher 2 steps card vs CPU, losses "
            f"{runs[dev]['losses']} vs {runs['cpu']['losses']}, "
            f"{rel:.3g} relative, moe_ep calls {ep} ({smi})")
        check(rel <= TOL_TRAIN, f"8l.1: {cfg.name} losses {smoke[cfg.name]}")
        want = 2 * 2 * cfg.num_layers if cfg.moe else 0
        check(ep == want, f"8l.1: {cfg.name} took moe_ep {ep} times, want "
              f"{want}")

    # 8l.2 one moe_ep layer at olmoe's full width, fp32
    cfg = get_config("olmoe-1b-7b").replace(dtype="float32")
    m = cfg.moe
    g = torch.Generator(dev).manual_seed(35)
    layer = moe_mod.MoE(cfg, device=dev)
    with torch.no_grad():
        for p in layer.parameters():
            fan_in = p.shape[-2] if p.ndim == 3 else p.shape[0]
            p.copy_(torch.randn(p.shape, generator=g, device=dev)
                    / fan_in ** 0.5)
    x = torch.randn((4, 512, cfg.d_model), generator=g, device=dev)
    T = x.shape[0] * x.shape[1]
    par = Parallel(model_axis="model", data_axes=("data",),
                   mesh=make_host_mesh(1, 1, device=dev), use_kernels=False)
    wide = cfg.replace(moe=dataclasses.replace(m, capacity_factor=8.0))
    moe_mod.moe_ep.record = []
    try:
        with torch.no_grad():
            y_ep, aux_ep = moe_mod.moe_apply(layer, wide, x, par)
            y_dn, aux_dn = moe_mod.moe_dense(layer, cfg, x)
            gates, idx, _ = moe_mod.route(layer.w_router,
                                          x.reshape(T, -1), m)
            dense_drops = int(moe_mod.dropped_pairs(
                gates, idx, m.num_experts, moe_mod.capacity(T, m)).sum())
            y_cf, _ = moe_mod.moe_apply(layer, cfg, x, par)
            ep_ms = cuda_ms(lambda: moe_mod.moe_apply(layer, cfg, x, par),
                            iters=10, warmup=2)
            dense_ms = cuda_ms(lambda: moe_mod.moe_dense(layer, cfg, x),
                               iters=10, warmup=2)
        drops = [int(n) for n in moe_mod.moe_ep.record[:2]]
    finally:
        moe_mod.moe_ep.record = None
    err = max_err(y_ep, y_dn)
    scale = float(y_dn.abs().max())
    per_expert = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
    layer_res = dict(tokens=T, experts=m.num_experts, top_k=m.top_k,
                     capacity_cf8=moe_mod.ep_capacity(T, wide.moe),
                     capacity_cf125=moe_mod.ep_capacity(T, m),
                     dense_capacity=moe_mod.capacity(T, m),
                     max_abs_err_vs_dense=err, max_abs_y=scale,
                     aux_ep=float(aux_ep), aux_dense=float(aux_dn),
                     dropped_pairs_cf8=drops[0], dropped_pairs_dense=dense_drops,
                     dropped_pairs_cf125=drops[1],
                     tokens_per_expert_max=int(per_expert.max()),
                     tokens_per_expert_min=int(per_expert.min()),
                     moe_ep_ms=ep_ms, moe_dense_ms=dense_ms)
    say(f"[8l.2] moe_ep at olmoe's width (64 experts top-8, fp32, 4 × 512): "
        f"vs moe_dense {err:.3g} (max|y| {scale:.3g}), aux {float(aux_ep):.6f}"
        f" vs {float(aux_dn):.6f}; capacity factor 1.25: "
        f"{layer_res['capacity_cf125']} rows an expert, {drops[1]} dropped "
        f"(token, expert) pairs of {T * m.top_k}; {ep_ms:.3f} ms a layer "
        f"(moe_dense {dense_ms:.3f}) ({smi})")
    check(drops[0] == 0 and dense_drops == 0,
          f"8l.2: pairs dropped at capacity factor 8: {layer_res}")
    check(err <= 1e-5 * scale and abs(float(aux_ep) - float(aux_dn)) <= 1e-6,
          f"8l.2: moe_ep vs moe_dense {layer_res}")
    check(bool(torch.isfinite(y_cf).all()), "8l.2: moe_ep at 1.25")
    del layer, x, y_ep, y_dn, y_cf

    # 8l.3 olmoe-1b-7b at full width, 2 of 16 layers, through the launcher
    cfg = get_config("olmoe-1b-7b").replace(num_layers=2)
    params = cfg.param_counts()["total"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    moe_mod.moe_ep.record = []
    calls = moe_mod.moe_ep.calls
    try:
        t0 = time.perf_counter()
        run = train(cfg, steps=10, batch=4, seq=512, lr=3e-4, device=dev,
                    log=say)
        wall = time.perf_counter() - t0
        drops = [int(n) for n in moe_mod.moe_ep.record]
    finally:
        moe_mod.moe_ep.record = None
    ep = moe_mod.moe_ep.calls - calls
    # with remat="full" (the config's) each layer's forward runs again in
    # the backward (counted in calls); a recompute stops once it holds what
    # the backward needs, which may be before moe_ep records its drops, so
    # a step's first records are its layers' forwards
    per_step = (2 if cfg.remat == "full" else 1) * cfg.num_layers
    k = len(drops) // 10
    ok_records = len(drops) == 10 * k and k >= cfg.num_layers
    drops = [drops[i * k:i * k + cfg.num_layers] for i in range(10)]
    peak = (torch.cuda.max_memory_allocated() - start) / 2**30
    state = run["state"]
    step = make_train_step(cfg, Parallel(
        model_axis="model", data_axes=("data",),
        mesh=make_host_mesh(1, 1, device=dev), use_kernels=False), lr=3e-4)
    batch = draw_batch(cfg, prng.fold_in(prng.PRNGKey(0), 10), 4, 512, dev)
    trace = device_busy(lambda: step(state, batch),
                        BUILD_DIR / "olmoe_launcher_step_trace.json")
    full = dict(config=cfg.name, layers="2 of 16", params=params,
                batch=[4, 512], steps=10, losses=run["losses"],
                grad_norms=run["grad_norms"], first_step_s=run["step_s"][0],
                s_per_step=sum(run["step_s"][1:]) / 9, wall_s=wall,
                peak_gib_above_start=peak,
                launches_a_step=trace["kernels"],
                traced_step_device_busy_s=trace["device_busy_s"],
                traced_step_idle_share=trace["device_idle_share"],
                remat=cfg.remat, moe_ep_calls=ep,
                dropped_pairs_per_step_and_layer=drops,
                capacity=moe_mod.ep_capacity(4 * 512, cfg.moe))
    say(f"[8l.3] olmoe-1b-7b full width, 2 of 16 layers ({params / 1e9:.3f}"
        f" B parameters), 10 steps of 4 × 512 through the launcher: "
        f"{full['s_per_step']:.4f} s a step after a first of "
        f"{full['first_step_s']:.3f} s, peak {peak:.2f} GiB, losses "
        f"{', '.join(f'{v:.4f}' for v in run['losses'])}; a traced step "
        f"{trace['kernels']} device launches, {trace['device_busy_s']:.4f} s"
        f" busy ({100 * trace['device_idle_share']:.1f}% idle); dropped "
        f"pairs of each step's layers {drops} of {4 * 512 * cfg.moe.top_k} "
        f"(capacity {full['capacity']}) ({smi})")
    check(all(math.isfinite(v) for v in run["losses"]),
          f"8l.3: losses {run['losses']}")
    check(ep == 10 * per_step and ok_records,
          f"8l.3: moe_ep took {ep} calls, {per_step} a step; dropped "
          f"pairs {drops}")
    del run, state, step, batch

    # 8l.4 the dry run on the meta device
    records = {}
    for arch, shape, want in (("xlstm-125m", "decode_32k", "ok"),
                              ("olmoe-1b-7b", "train_4k", "ok"),
                              ("hubert-xlarge", "decode_32k", "skip")):
        t0 = time.perf_counter()
        rec = dryrun.build(arch, shape)
        rec["seconds"] = time.perf_counter() - t0
        records[f"{arch}|{shape}"] = rec
        say(f"[8l.4] dry run {arch} × {shape}: {rec['status']} in "
            f"{rec['seconds']:.2f} s: {json.dumps(rec)}")
        check(rec["status"] == want, f"8l.4: {arch} × {shape} is "
              f"{rec['status']}, want {want}")
    check(records["xlstm-125m|decode_32k"]["roofline"]["t_compute"] < 1e-3,
          "8l.4: xlstm-125m decode t_compute")
    launches = {name: fn.launches for name, fn in fns.items()}
    check(launches == {name: 0 for name in fns},
          f"8l: training launched kernels {launches}")
    say(json.dumps({"launcher_and_moe_ep": {
        "launcher_card_vs_cpu_smoke": smoke, "moe_ep_layer": layer_res,
        "olmoe_1b_7b_two_layers": full,
        "dry_run_seconds": {k: v["seconds"] for k, v in records.items()},
        "card": smi}}))


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.oscar import (DataConfig, DiffusionConfig,
                                           OscarConfig)
    from repro_torch.core import classifier_train as ct
    from repro_torch.core import comm
    from repro_torch.core import experiment as exp_mod
    from repro_torch.core import oscar as oscar_mod
    from repro_torch.core import dm_baselines as dm_mod
    from repro_torch.core.dm_baselines import run_fedcado, run_feddisc
    from repro_torch.core.fl import run_fl
    from repro_torch.core.oscar import client_encodings, synthesize
    from repro_torch.data.federated import make_federated_data
    from repro_torch.diffusion import ddpm
    from repro_torch.diffusion import guidance as guid
    from repro_torch.diffusion.dit import init_dit
    from repro_torch.diffusion.sampler import (sample_cfg,
                                               sample_cfg_compacted,
                                               sample_cfg_ragged,
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
    from repro_torch.kernels.moe import kernel as moe_kernel
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.models.classifiers import (classifier_logprob,
                                                init_classifier)
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_serve_step
    from repro_torch.obs import Tracer, validate_chrome_trace, write_trace
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import (AllHostsLostError, FaultInjector,
                                   RequestFailedError, RetryPolicy,
                                   SynthesisService, SynthesisStore)
    from repro_torch.serve import synthesis as serve_synthesis
    from repro_torch.serve.synthesis import SynthesisEngine
    from repro_torch.serve.topology import HostTopology
    from repro_torch.utils import (default_device, deterministic_cudnn,
                                   recorded_relu)

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
               moe_kernel.SOURCE, EMPTY_SOURCE)
    t0 = time.perf_counter()
    nvcc_s = compile_all(sources)
    t_nvcc = time.perf_counter() - t0
    fa_kernel.build()
    fa_kernel.build_tc()
    fa_kernel.build_short()
    an_kernel.build()
    rn_kernel.build()
    cfg_kernel.build()
    moe_kernel.build()
    for src in sources:
        log = build_log(src)
        if src in (fa_kernel.TC_SOURCE, cfg_kernel.SOURCE, moe_kernel.SOURCE,
                   EMPTY_SOURCE):
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
    moe_log = build_log(moe_kernel.SOURCE)
    moe_spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", moe_log)
    # two grouped GEMM epilogues and the combine
    check(len(moe_spills) == 3 and all(a == b == "0" for a, b in moe_spills),
          f"moe.cu spills: {moe_spills}")
    check("Performance Loss" not in moe_log, "ptxas serialised the wgmma "
          "instructions of moe.cu")
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
    say(f"[1] build: nvcc {t_nvcc:.2f} s for all eight sources together ("
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

    # the MoE's compact expert pass at olmoe-prefill-docs's wave (T 32,768,
    # 64 experts top-8, d 2048, fe 1024, capacity 16,384) in bf16 on one
    # random routing, weights and rows from a generator of their own.  The
    # kernels' rows against the plain versions (two bf16 ulps of the largest
    # value: the card's bf16 matmuls sum in another order), the combine bit
    # for bit.  The bounds count the kept rows only (the tile's pad rows are
    # waste): operations at the bf16 peak for the products, bytes for the
    # combine.  The library column is torch._grouped_mm over the same rows
    # (a yardstick only; the port's path never calls it): the down product
    # as it is, and for the up kernel its two products alone, on rows
    # gathered beforehand, without the activation
    from repro_torch.configs import get_config as lm_config
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.kernels.moe import ref as moe_ref
    from repro_torch.kernels.moe.kernel import BM as MOE_BM
    from repro_torch.models import moe as moe_mod
    ocfg = lm_config("olmoe-1b-7b")
    om = ocfg.moe
    T_o, d_o, fe_o = 8 * 4096, ocfg.d_model, om.d_ff_expert
    g31 = torch.Generator(dev).manual_seed(31)

    def draw31(*shape):
        return (torch.randn(shape, generator=g31, device=dev)
                / shape[-2] ** 0.5).bfloat16()
    w_up, w_gate = draw31(om.num_experts, d_o, fe_o), draw31(
        om.num_experts, d_o, fe_o)
    w_down, w_rt = draw31(om.num_experts, fe_o, d_o), draw31(
        d_o, om.num_experts)
    xo = torch.randn((T_o, d_o), generator=g31, device=dev).bfloat16()
    with torch.inference_mode():
        o_gates, o_idx, _ = moe_mod.route(w_rt, xo, om)
        oc = moe_mod.compact_dispatch(o_gates, o_idx, om.num_experts,
                                      moe_mod.capacity(T_o, om))
        up_args = (xo, oc.rows, oc.tile_start, w_up, w_gate, "silu",
                   oc.group_div, oc.tiles_max)
        dn_args = (oc.tile_start, w_down, oc.group_div, oc.tiles_max)
        h_o = moe_ops.expert_up(*up_args)
        h_ref = moe_ref.expert_up(*up_args)
        y_o = moe_ops.expert_down(h_o, *dn_args)
        y_ref = moe_ref.expert_down(h_o, *dn_args)
        out_o = moe_ops.combine(y_o, oc.pair_rows, oc.pair_gates)
        out_ref = moe_ref.combine(y_o, oc.pair_rows, oc.pair_gates)
        kept = int((oc.rows >= 0).sum())
        live = int(oc.tile_start[-1]) * MOE_BM
        ends = (oc.tile_start[1:] * MOE_BM).to(torch.int32)
        x_rows = xo[oc.rows.long().clamp(min=0)]
    moe_checks = {}
    for name, got, want in (("up", h_o, h_ref), ("down", y_o, y_ref)):
        scale = float(want[:live].float().abs().max())
        check(scale > 1e-3, f"moe {name}: vacuous rows")
        moe_checks[name] = dict(
            mode=name, shape=[T_o, om.num_experts, om.top_k, d_o, fe_o],
            kept_rows=kept, computed_rows=live,
            max_abs_err=max_err(got[:live], want[:live]), max_abs_y=scale,
            tol=2.0 ** -6 * scale)
    check(torch.equal(out_o, out_ref), "moe combine: not bit-equal to the "
          "plain gather-add")
    del h_ref, y_ref, out_ref
    moe_shape = [T_o, om.num_experts, om.top_k, d_o, fe_o]

    def moe_inf(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call
    record("moe_expert_up", "cuda",
           "src/repro_torch/kernels/moe/csrc/moe.cu", None,
           moe_checks["up"]["tol"], [moe_checks["up"]],
           moe_inf(lambda: moe_ops.expert_up(*up_args)),
           moe_inf(lambda: moe_ref.expert_up(*up_args)), None,
           2 * (kept * d_o + 2 * om.num_experts * d_o * fe_o + kept * fe_o),
           2 * 2 * kept * d_o * fe_o, moe_shape, peak=BF16_FLOPS, iters=10,
           mode="up and gate products, silu, product (olmoe-prefill-docs's "
                "wave), grouped wgmma kernel, rows gathered on the chip",
           grouped_mm_two_products_ms=cuda_ms(moe_inf(lambda: (
               torch._grouped_mm(x_rows, w_up, offs=ends),
               torch._grouped_mm(x_rows, w_gate, offs=ends))), 10),
           kept_rows=kept, computed_rows=live)
    record("moe_expert_down", "cuda",
           "src/repro_torch/kernels/moe/csrc/moe.cu", None,
           moe_checks["down"]["tol"], [moe_checks["down"]],
           moe_inf(lambda: moe_ops.expert_down(h_o, *dn_args)),
           moe_inf(lambda: moe_ref.expert_down(h_o, *dn_args)),
           moe_inf(lambda: torch._grouped_mm(h_o, w_down, offs=ends)),
           2 * (kept * fe_o + om.num_experts * fe_o * d_o + kept * d_o),
           2 * kept * fe_o * d_o, moe_shape, peak=BF16_FLOPS, iters=10,
           mode="down product (olmoe-prefill-docs's wave), grouped wgmma "
                "kernel",
           library_call="torch._grouped_mm, offs at the groups' tile ends",
           kept_rows=kept, computed_rows=live)
    record("moe_combine", "cuda",
           "src/repro_torch/kernels/moe/csrc/moe.cu", None, 0.0,
           [dict(mode="combine", shape=moe_shape, max_abs_err=0.0,
                 bit_equal=True)],
           moe_inf(lambda: moe_ops.combine(y_o, oc.pair_rows,
                                           oc.pair_gates)),
           moe_inf(lambda: moe_ref.combine(y_o, oc.pair_rows,
                                           oc.pair_gates)), None,
           2 * kept * d_o + 2 * T_o * d_o + 8 * T_o * om.top_k,
           2 * kept * d_o, moe_shape, peak=BF16_FLOPS, iters=10,
           mode="weighted sum of each token's rows in ascending expert order "
                "(olmoe-prefill-docs's wave), one launch",
           kept_rows=kept)
    del xo, h_o, y_o, out_o, x_rows, w_up, w_gate, w_down, oc

    # -- 3. the DiT at full width --------------------------------------------
    dc = DiffusionConfig(d_model=144, num_layers=4, num_heads=4, patch=4,
                         cond_dim=512)
    model = init_dit(prng.PRNGKey(1), dc, 16, 3, device=dev)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    model.eval()
    plain = copy.deepcopy(model)   # the reference: plain PyTorch versions
    plain.plain = True
    B = 256
    xt, yy = randn(B, 16, 16, 3), randn(B, 512)
    tt = torch.randint(0, 1000, (B,), generator=g, device=dev)
    dit_err = 0.0      # the amplitude of the 4-step gates' probe
    with torch.inference_mode():
        for y_in in (yy, None):
            ref = plain(xt, tt, y_in)
            out = model(xt, tt, y_in)
            err = max_err(out, ref)
            dit_err = max(dit_err, err)
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
    model16, dit16_err = phase_3c(model, plain, xt, tt, yy, dict(
        ms=dit_ms, host_ms=dit_host_ms, device_ms=dit_dev_ms), smi)

    # -- 3b. the classifier on the card --------------------------------------
    # ResNet-18 at a mixed wave's width: logits and the guidance gradient
    # ∇ log p(y|x) against the CPU run of the same weights, and whether
    # cuDNN's own choice of backward algorithms repeats bit for bit.  The
    # gradient of a ReLU net jumps where a ReLU input crosses 0, and the
    # card and the CPU round those inputs differently by ~1e-7, so the
    # gradient is gated on the samples whose ReLU inputs (CPU run) all lie
    # at least 1e-6 from 0; the error over every sample is printed
    clf = init_classifier(prng.PRNGKey(7), "resnet18", 10, device=dev)
    logprob = classifier_logprob(clf)
    xc = torch.rand((120, 16, 16, 3), generator=g, device=dev) * 2 - 1
    yc = torch.randint(0, 10, (120,), generator=g, device=dev)
    clf_cpu = copy.deepcopy(clf).cpu()

    def unit(v):
        return v / v.flatten(1).norm(dim=1).clamp(min=1e-6)[:, None, None,
                                                           None]

    margins = []
    with torch.no_grad():
        with recorded_relu(lambda v: margins.append(
                v.abs().flatten(1).amin(1))):
            logits_cpu = clf_cpu(xc.cpu())
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
    data = make_federated_data(DataConfig(**PAPER_DATA))
    t0 = time.perf_counter()
    enc, present = client_encodings(FrozenFM(), data, device=dev)
    t_enc = time.perf_counter() - t0
    # the encodings are reproducible: twice here and once in a child
    # process, bit for bit (a fixed-order per-category sum on the card)
    digests = [enc_digest(enc, present), enc_digest(*client_encodings(
        FrozenFM(), data, device=dev))]
    child = subprocess.run(
        [sys.executable, "-c", ENC_CHILD], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(child.returncode == 0, f"encodings child process: {child.stderr}")
    digests.append(child.stdout.strip().splitlines()[-1])
    say(f"[4] client encodings SHA-256: this process {digests[0]}, again "
        f"{digests[1]}, child process {digests[2]}")
    check(len(set(digests)) == 1, f"client encodings differ: {digests}")
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
    out = sample_cfg(model, sched, rows, num_steps=4, x_T=x_T, noise=noise)
    # z from memory: the x_T= / noise= injection
    kernels["cfg_update"]["launches_4_step_injected_noise_waves"] = \
        cfg_ops.cfg_update.launches - n0
    gated4 = row_gated("4-step wave", out, lambda m: sample_cfg(
        m, sched, rows, num_steps=4, x_T=x_T, noise=noise), plain, dit_err)
    say(f"[4] 4-step wave of 8 rows: kernel path vs plain path max_abs_err "
        f"{gated4['max_err']:.3g}; each row's error/probe movement "
        f"{rows_line(gated4)} (probe ±{dit_err:.3g}; gate max({TOL_E2E:g}, "
        f"{K_PROBE:g}·probe), {gated4['rows_over_tol']} of 8 rows above "
        f"{TOL_E2E:g})")

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
    # (and the wave geometries the engine counts, as the reference counts
    # its compiled ones)
    plan = {"ragged": dict(iters=0, scheduled=0, segments=0),
            "compacted": dict(iters=0, scheduled=0, segments=0)}
    shapes6 = {"ragged": set(), "compacted": set()}
    smax = 0
    for w in range(0, n_rows, 120):
        st_w = row_steps[w:w + 120]
        smax = max(smax, int(st_w.max()))
        plan["ragged"]["iters"] += smax
        plan["ragged"]["scheduled"] += 120 * smax
        shapes6["ragged"].add(("cfg-ragged", 120, smax))
        _, epochs = guid.plan_epochs(st_w, smax, compaction="full")
        plan["compacted"]["iters"] += sum(e - b for _, b, e in epochs)
        plan["compacted"]["scheduled"] += sum(r * (e - b)
                                              for r, b, e in epochs)
        plan["compacted"]["segments"] += len(epochs)
        prev = 0
        for r, b, e in epochs:
            shapes6["compacted"].add(("cfg-seg", prev, r, e - b))
            prev = r
    active_iters = int(row_steps.sum())
    check(plan["ragged"]["scheduled"] == 90000 and active_iters == 67500
          and plan["compacted"]["scheduled"] == 67500,
          f"phase 6 plan {plan}, active {active_iters}")
    ragged_iters6 = plan["ragged"]["iters"]        # phase 11.4's plan too
    compacted_iters6 = plan["compacted"]["iters"]  # and phase 12's

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
            want_stats = dict(requests=60, waves=15, generated=n_rows,
                              scheduled_rows=n_rows, padded=0, cache_hits=0,
                              store_hits=0, streamed=0, merged_waves=15,
                              compiled_shapes=len(shapes6[mode]),
                              segments=p6["segments"],
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
    # all four (guidance, steps) and the whole 120-row wave at 4/2 steps,
    # each row gated by its conditioning as phase 4 holds sample_cfg, and
    # the whole wave at 50/25 steps, where the step-aware gate is 2e-2
    pick = [0, 1, 30, 31, 60, 61, 90, 91]
    gated6 = row_gated("4-step ragged rows", whole[pick],
                       lambda m: sample_cfg_ragged(
                           m, sched, y4[pick], keys4[pick], g4[pick],
                           s4[pick]), plain, dit_err)
    gated120 = row_gated("4-step ragged wave of 120 rows", whole,
                         lambda m: sample_cfg_ragged(m, sched, y4, keys4, g4,
                                                     s4), plain, dit_err)
    err_plain, err_plain_120 = gated6["max_err"], gated120["max_err"]
    g50 = np.repeat([c[0] for c in combos], 30).astype(np.float32)
    s50 = np.repeat([c[1] for c in combos], 30)
    deep, deep_plain = (sample_cfg_ragged(m, sched, y4, keys4, g50, s50)
                        for m in (model, plain))
    err_plain_deep = max_err(deep, deep_plain)
    check(float(deep_plain.abs().max()) > 1e-3, "vacuous ragged parity")
    check(err_plain_deep <= TOL_E2E_DEEP, f"50/25-step ragged wave kernel "
          f"vs plain {err_plain_deep:.3g}")
    worst120 = sorted(range(120), key=lambda i: -gated120["err"][i])[:4]
    say(f"[6] ragged wave, kernel path vs plain DiT (probe ±{dit_err:.3g}; "
        f"gate max({TOL_E2E:g}, {K_PROBE:g}·probe)): 8 rows at 4/2 steps "
        f"max_abs_err {err_plain:.3g}, each row's error/probe movement "
        f"{rows_line(gated6)}; 120 rows at 4/2 steps {err_plain_120:.3g} "
        f"({gated120['rows_over_tol']} rows above {TOL_E2E:g}; the largest "
        f"errors/probe movements "
        + "; ".join(f"row {i} {gated120['err'][i]:.3g}/"
                    f"{gated120['probe'][i]:.3g}" for i in worst120)
        + f"); 120 rows at 50/25 steps {err_plain_deep:.3g} (tol "
        f"{TOL_E2E_DEEP:g})")

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
            "120_rows_4_steps": err_plain_120},
        "4_step_rows": {"phase4": gated4, "phase6_8_rows": gated6,
                        "phase6_120_rows": gated120, "k_probe": K_PROBE},
        "card": smi}}))

    # -- 7. mixed guidance modes ---------------------------------------------
    # the reference benchmark's _bench_mixed_guidance request set at the
    # paper preset: the 60 uploads of phase 6 (rids 0-59), one
    # classifier-guided request per category (rids 60-69: guidance 1.0, 25
    # steps and the first classifier for an even category, 50 steps and
    # the second for an odd one) and four unconditional requests (rids
    # 70-73: 50 steps for an even category, 25 for an odd one), 30 samples
    # each.  The classifiers are two ResNet-18s at their initial weights
    # (keys 70 and 71), as two clients
    # would upload them: the repository has no trained one yet.
    clfs = [classifier_logprob(init_classifier(
        prng.PRNGKey(70 + i), "resnet18", 10, device=dev)) for i in range(2)]
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
    shapes7 = {m: set() for m in plan7}
    smax = 0
    for w in range(nw):
        part = rows7[w * w7:(w + 1) * w7]
        part = part + [part[-1]] * (w7 - len(part))
        st_w = np.array([r[0] for r in part])
        smax = max(smax, int(st_w.max()))
        kind = "mixed" if any(r[1] for r in part) else "rowwise"
        plan7["ragged"][kind] += smax
        plan7["ragged"]["scheduled"] += w7 * smax
        shapes7["ragged"].add(
            ("mixed-ragged", w7, smax, 2) if kind == "mixed"
            else ("cfg-ragged", w7, smax))
        _, epochs = guid.plan_epochs(st_w, smax, compaction="full")
        plan7["compacted"][kind] += sum(e - b for _, b, e in epochs)
        plan7["compacted"]["scheduled"] += sum(r * (e - b)
                                               for r, b, e in epochs)
        plan7["compacted"]["segments"] += len(epochs)
        prev = 0
        for r, b, e in epochs:
            shapes7["compacted"].add(
                ("mixed-seg", prev, r, e - b, 2) if kind == "mixed"
                else ("cfg-seg", prev, r, e - b))
            prev = r
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
            want_stats = dict(requests=74, waves=nw, generated=n7,
                              scheduled_rows=nw * w7, padded=nw * w7 - n7,
                              cache_hits=0, store_hits=0, streamed=0,
                              merged_waves=nw,
                              compiled_shapes=len(shapes7[mode]),
                              segments=p7["segments"],
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
    # 4 layers, batch 8, weights from key 2 perturbed 0.05·normal.  The
    # perturbation and the inputs come from a generator of their own (later
    # phases draw what they drew before), and it runs after the synthesis
    # rounds, whose rates it would otherwise precede with a traced call
    g224 = torch.Generator(dev).manual_seed(224)
    model224 = init_dit(prng.PRNGKey(2), dc, 224, 3, device=dev)
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
        # 7c's 224-px call: the same with bf16_act, attention still fp32 on
        # the CUDA-core kernel
        m224_16 = bf16_act_model(model224)
        n_cc = fa.launches_cuda_core
        out224_16 = m224_16(x224, t224, y224)
        torch.cuda.synchronize()
        check(fa.launches_cuda_core - n_cc == dc.num_layers,
              "224-px DiT with bf16_act: attention left the CUDA cores")
        err224_16 = max_err(out224_16, ref224)
        gate224_16 = TOL_BF16_ACT * max(float(ref224.abs().max()), 1.0)
        check(err224_16 < gate224_16, f"224-px DiT bf16_act vs plain "
              f"{err224_16:.3g} >= {gate224_16:.3g}")
        bf16_224 = dict(max_abs_err_vs_plain=err224_16, gate=gate224_16,
                        device_ms=graph_ms(lambda: m224_16(x224, t224, y224),
                                           3),
                        ms_per_call=cuda_ms(lambda: m224_16(x224, t224, y224),
                                            5))
        del m224_16, out224_16
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
        "top_device_us": trace224["top_device_us"][:5], "bf16_act": bf16_224,
        "card": smi}}))
    say(f"[7c] 224-px DiT with bf16_act: {bf16_224['device_ms']:.3f} ms on "
        f"the device against {dit224_dev_ms:.3f} ms in fp32; vs plain "
        f"{err224_16:.3g} (gate {gate224_16:.3g}) ({smi})")
    del model224, plain224, out224, ref224, x224

    # -- 7c. a uniform D_syn round with bf16_act -----------------------------
    phase_7c(lambda m: synthesize(prng.PRNGKey(2), m, sched, enc, present,
                                  k_samples, image_size=16,
                                  wave_size=wave)[0],
             model, model16, first_images, rounds, fns, want, dit16_err, smi)
    del model16

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

    # the tensor-core kernel at olmoe-1b-7b's prefill layer (8d's wave A:
    # B 4, S 2048, 16/16 heads of 128, bf16, causal), drawn from a generator
    # of its own.  The library column is SDPA (causal, no GQA, no window or
    # softcap: here the same function); flex_attention compiled with a
    # causal BlockMask is timed beside it
    g25 = torch.Generator(dev).manual_seed(25)
    qo, ko, vo = (torch.randn((4, 2048, 16, 128), generator=g25,
                              device=dev).bfloat16() for _ in range(3))
    kw_o = dict(causal=True, window=0, softcap=0.0)
    n_tc = fa.launches_tensor_core
    o_out = fa(qo, ko, vo, **kw_o)
    check(fa.launches_tensor_core == n_tc + 1, "olmoe's prefill layer did "
          "not take the tensor-core kernel")
    o_ref = plain_lm_attn(qo, ko, vo, **kw_o)
    o_err, o_rel = max_err(o_out, o_ref), row_rel_err(o_out, o_ref)
    check(o_err <= TOL_ATTN_BF16 and o_rel <= TOL_ATTN_BF16_ROW,
          f"flash_attention at olmoe's layer: max abs error {o_err:.3g}, "
          f"row-relative {o_rel:.3g}")
    bhsd_o = [t.transpose(1, 2) for t in (qo, ko, vo)]
    flex_o = flex_o_err = flex_o_s = None
    if flex:
        bm_o = create_block_mask(causal_mask, None, None, 2048, 2048,
                                 device=dev)

        def flex_o():
            return flex_c(*bhsd_o, block_mask=bm_o)
        t0 = time.perf_counter()
        flex_o_err = max_err(flex_o().transpose(1, 2), o_ref)
        flex_o_s = time.perf_counter() - t0
    del o_out

    def sdpa_o():
        return torch.nn.functional.scaled_dot_product_attention(
            *bhsd_o, is_causal=True)

    record("flash_attention_lm_olmoe", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention_tc.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN_BF16,
           [dict(mode="olmoe_causal", shape=[4, 2048, 16, 16, 128],
                 max_abs_err=o_err, max_row_rel_err=o_rel)],
           lambda: fa(qo, ko, vo, **kw_o),
           lambda: plain_lm_attn(qo, ko, vo, **kw_o), sdpa_o,
           2 * (2 * qo.numel() + ko.numel() + vo.numel()),
           4 * 128 * 4 * 16 * attn_pairs(2048, 2048, True, 0),
           [4, 2048, 16, 16, 128], peak=BF16_FLOPS, iters=5, phase=8,
           mode="causal, MHA 16/16, head dim 128, bf16 (olmoe-1b-7b, 8d's "
                "wave A prefill), tensor-core kernel",
           launch_floor_ms=graph_ms(lambda: empty_launch(
               (fa_kernel.work_list(2048, 2048, True, 0).shape[0] * 4 * 16,
                1), 384, 1024 + 6 * (128 // 64) * 64 * 128 + 64,
               torch.cuda.current_device())),
           library_call="scaled_dot_product_attention, is_causal",
           library_max_abs_err=max_err(sdpa_o().transpose(1, 2), o_ref),
           flex_attention_ms=cuda_ms(flex_o, 5) if flex else None,
           flex_attention_device_ms=graph_ms(flex_o, 2) if flex else None,
           flex_attention_max_abs_err=flex_o_err,
           flex_attention_first_call_s=flex_o_s)
    del o_ref
    del bhsd_o, qo, ko, vo

    # the tensor-core kernel at jamba-1.5-large's attention layer (8g's wave
    # A: B 2, S 2048, GQA 64/8 heads of 128, bf16, causal), drawn from a
    # generator of its own.  The library column is SDPA with
    # ``enable_gqa`` (causal, no window or softcap: the same function)
    g28 = torch.Generator(dev).manual_seed(28)
    qj = torch.randn((2, 2048, 64, 128), generator=g28,
                     device=dev).bfloat16()
    kj, vj = (torch.randn((2, 2048, 8, 128), generator=g28,
                          device=dev).bfloat16() for _ in range(2))
    n_tc = fa.launches_tensor_core
    j_out = fa(qj, kj, vj, **kw_o)
    check(fa.launches_tensor_core == n_tc + 1, "jamba's attention layer did "
          "not take the tensor-core kernel")
    j_ref = plain_lm_attn(qj, kj, vj, **kw_o)
    j_err, j_rel = max_err(j_out, j_ref), row_rel_err(j_out, j_ref)
    check(j_err <= TOL_ATTN_BF16 and j_rel <= TOL_ATTN_BF16_ROW,
          f"flash_attention at jamba's layer: max abs error {j_err:.3g}, "
          f"row-relative {j_rel:.3g}")
    bhsd_j = [t.transpose(1, 2) for t in (qj, kj, vj)]

    def sdpa_j():
        return torch.nn.functional.scaled_dot_product_attention(
            *bhsd_j, is_causal=True, enable_gqa=True)

    record("flash_attention_lm_jamba", "cuda",
           "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention_tc.cu",
           "src/repro/kernels/flash_attention/kernel.py:85", TOL_ATTN_BF16,
           [dict(mode="jamba_causal_gqa", shape=[2, 2048, 64, 8, 128],
                 max_abs_err=j_err, max_row_rel_err=j_rel)],
           lambda: fa(qj, kj, vj, **kw_o),
           lambda: plain_lm_attn(qj, kj, vj, **kw_o), sdpa_j,
           2 * (2 * qj.numel() + kj.numel() + vj.numel()),
           4 * 128 * 2 * 64 * attn_pairs(2048, 2048, True, 0),
           [2, 2048, 64, 8, 128], peak=BF16_FLOPS, iters=5, phase=8,
           mode="causal, GQA 64/8, head dim 128, bf16 (jamba-1.5-large, 8g's "
                "wave A prefill), tensor-core kernel",
           launch_floor_ms=graph_ms(lambda: empty_launch(
               (fa_kernel.work_list(2048, 2048, True, 0).shape[0] * 2 * 64,
                1), 384, 1024 + 6 * (128 // 64) * 64 * 128 + 64,
               torch.cuda.current_device())),
           library_call="scaled_dot_product_attention, is_causal, enable_gqa",
           library_max_abs_err=max_err(sdpa_j().transpose(1, 2), j_ref))
    del j_out, j_ref, bhsd_j, qj, kj, vj

    # the tensor-core kernel at the frontend models' prefill layers (8i's
    # hubert-xlarge encoder: B 8, 1024 frames, 16/16 heads of 80, non-causal,
    # the 128-column class with columns 80-127 zero; 8j's internvl2-1b: B 8,
    # 256 patches + 256 tokens, GQA 14/2 heads of 64, causal), and the
    # CUDA-core kernel at hubert's heads in fp32 (8i's fp32 gate: B 2, the
    # class of 96), each from a generator of its own.  The library column
    # is SDPA, there the same function (non-causal; causal with
    # ``enable_gqa``); the launches are 8i's and 8j's (set there)
    for tag, seed, shape, causal, dtype in (
            ("flash_attention_lm_hubert", 30, (8, 1024, 16, 16, 80), False,
             torch.bfloat16),
            ("flash_attention_lm_internvl", 31, (8, 512, 14, 2, 64), True,
             torch.bfloat16),
            ("flash_attention_fp32_hd80", 30, (2, 1024, 16, 16, 80), False,
             torch.float32)):
        Bf, Sf, hqf, hkvf, hdf = shape
        gf = torch.Generator(dev).manual_seed(seed)
        qf = torch.randn((Bf, Sf, hqf, hdf), generator=gf, device=dev)
        kf, vf = (torch.randn((Bf, Sf, hkvf, hdf), generator=gf, device=dev)
                  for _ in range(2))
        qf, kf, vf = (t.to(dtype) for t in (qf, kf, vf))
        kw_f = dict(causal=causal, window=0, softcap=0.0)
        tc = dtype == torch.bfloat16
        n_route = (fa.launches_tensor_core, fa.launches_cuda_core)
        f_out = fa(qf, kf, vf, **kw_f)
        check((fa.launches_tensor_core - n_route[0],
               fa.launches_cuda_core - n_route[1]) == ((1, 0) if tc
                                                       else (0, 1)),
              f"{tag}: the call did not take the "
              f"{'tensor-core' if tc else 'CUDA-core'} kernel")
        f_ref = plain_lm_attn(qf, kf, vf, **kw_f)
        f_err = max_err(f_out, f_ref)
        f_check = dict(mode=f"{'causal' if causal else 'noncausal'}_"
                       f"{hqf}_{hkvf}_hd{hdf}", shape=list(shape),
                       max_abs_err=f_err)
        if tc:
            f_check["max_row_rel_err"] = row_rel_err(f_out, f_ref)
            check(f_err <= TOL_ATTN_BF16
                  and f_check["max_row_rel_err"] <= TOL_ATTN_BF16_ROW,
                  f"{tag}: max abs error {f_err:.3g}, row-relative "
                  f"{f_check['max_row_rel_err']:.3g}")
        del f_out
        bhsd_f = [t.transpose(1, 2) for t in (qf, kf, vf)]

        def sdpa_f(bhsd_f=bhsd_f, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                *bhsd_f, is_causal=causal, enable_gqa=True)

        hdp = 128 if hdf > 64 else 64            # the tensor-core class
        floor = (
            (lambda: empty_launch(
                (fa_kernel.work_list(Sf, Sf, causal, 0).shape[0] * Bf * hqf,
                 1), 384, 1024 + 6 * (hdp // 64) * 64 * 128 + 64,
                torch.cuda.current_device())) if tc else
            (lambda: fa_kernel.cuda_core_empty_launch(qf, kf, vf)))
        record(tag, "cuda",
               "src/repro_torch/kernels/flash_attention/csrc/"
               + ("flash_attention_tc.cu" if tc else "flash_attention.cu"),
               "src/repro/kernels/flash_attention/kernel.py:85",
               TOL_ATTN_BF16 if tc else TOL_ATTN, [f_check],
               lambda: fa(qf, kf, vf, **kw_f),
               lambda: plain_lm_attn(qf, kf, vf, **kw_f), sdpa_f,
               qf.element_size() * (2 * qf.numel() + kf.numel()
                                    + vf.numel()),
               4 * hdf * Bf * hqf * attn_pairs(Sf, Sf, causal, 0),
               list(shape), peak=BF16_FLOPS if tc else FP32_FLOPS, iters=5,
               phase=8,
               mode={"flash_attention_lm_hubert":
                     "non-causal, MHA 16/16, head dim 80 (the 128-column "
                     "class), bf16 (hubert-xlarge, 8i's encoder), "
                     "tensor-core kernel",
                     "flash_attention_lm_internvl":
                     "causal, GQA 14/2, head dim 64, bf16 (internvl2-1b, "
                     "8j's prefill of 256 patches and 256 tokens), "
                     "tensor-core kernel",
                     "flash_attention_fp32_hd80":
                     "non-causal, MHA 16/16, head dim 80 (the class of 96),"
                     " fp32 (hubert-xlarge, 8i's fp32 gate), CUDA-core "
                     "kernel"}[tag],
               launch_floor_ms=graph_ms(floor),
               library_call="scaled_dot_product_attention"
                            + (", is_causal, enable_gqa" if causal else ""),
               library_max_abs_err=max_err(sdpa_f().transpose(1, 2), f_ref),
               hd_class=hdp if tc else 96,
               useful_share_of_products=hdf / (hdp if tc else 96))
        del f_ref, bhsd_f, qf, kf, vf

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

    # 8b. full-width serving in bf16: init_lm's weights from key 14, drawn
    # on the card (the repository holds no gemma2 checkpoint), two rounds of
    # wave A (4 x 4608-token prompts, past the 4096 window, 32 new tokens)
    # and wave B (16 x 512, 64 new tokens), the last-position read-out only
    # after prefill
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = init_lm(prng.PRNGKey(14), lm_cfg, device=dev)
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
    # same key's weights: one 4608-token request, 8 new tokens
    del lm, eng, step, timed_step, serve_step, fwd, timed_forward, logits_a
    torch.cuda.empty_cache()
    cfg32 = lm_cfg.replace(dtype="float32")
    lm32 = init_lm(prng.PRNGKey(14), cfg32, device=dev)
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
    del lm32, eng32              # the engine holds the model

    # -- 8d-8f. MoE FFNs and the dense decoder configs -----------------------
    t8 = time.perf_counter()
    kernels["flash_attention_lm_olmoe"]["launches"], moe_n = phase_8d(
        dev, fns, smi)
    for name in moe_n:
        kernels[f"moe_{name}"]["launches"] = moe_n[name]
    phase_8e(dev, fns, smi)
    phase_8f(dev, fns, smi)
    say(f"[8d-8f] MoE and dense decoder configs: "
        f"{time.perf_counter() - t8:.1f} s")

    # -- 8g-8h. the recurrent mixers: jamba-1.5-large and xlstm-125m ---------
    t8 = time.perf_counter()
    kernels["flash_attention_lm_jamba"]["launches"] = phase_8g(dev, fns, smi)
    say(f"[8g] jamba: {time.perf_counter() - t8:.1f} s")
    t8 = time.perf_counter()
    phase_8h(dev, fns, smi)
    say(f"[8h] xlstm-125m: {time.perf_counter() - t8:.1f} s")

    # -- 8i-8k. the frontends, the encoder head and LM training -------------
    t8 = time.perf_counter()
    for name, n in phase_8i(dev, fns, smi).items():
        kernels[name]["launches"] = n
    say(f"[8i] hubert-xlarge: {time.perf_counter() - t8:.1f} s")
    t8 = time.perf_counter()
    kernels["flash_attention_lm_internvl"]["launches"] = phase_8j(dev, fns,
                                                                  smi)
    say(f"[8j] internvl2-1b: {time.perf_counter() - t8:.1f} s")
    t8 = time.perf_counter()
    phase_8k(dev, fns, smi)
    say(f"[8k] LM training: {time.perf_counter() - t8:.1f} s")

    # -- 8l. the training launcher, expert-parallel MoE and the dry run ------
    t8 = time.perf_counter()
    phase_8l(dev, fns, smi)
    say(f"[8l] launcher, moe_ep and dry run: {time.perf_counter() - t8:.1f} s")

    # -- 9. the paper's methods end to end -----------------------------------
    # benchmarks/common.py's paper preset: phase 4's data and DiT, 30
    # samples a (client, category), ResNet-18 trained 400 steps of 64
    t9 = time.perf_counter()
    ocfg = OscarConfig(data=DataConfig(**PAPER_DATA), diffusion=dc,
                       samples_per_category=k_samples, classifier_steps=400,
                       classifier_batch=64)
    R, C = data.client_images.shape[0], data.num_categories
    clients = ["avg"] + [f"client{r + 1}" for r in range(R)]
    stage_s = {"synthesis": [], "training": []}
    train_peak = []

    def staged(fn, stage):
        """``fn`` timed by host clock to the end of its device work; the
        training stage also records its peak device memory above what was
        allocated when it began."""
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[stage].append(time.perf_counter() - t)
            if stage == "training":
                train_peak.append(torch.cuda.max_memory_allocated() - base)
            return out
        return call

    def zero_counts():
        for fn in fns.values():
            fn.launches = 0
        cfg_ops.cfg_update.launches_keyed = 0
        fa_ops.flash_attention.launches_short = 0
        fa_ops.flash_attention.launches_cuda_core = 0
        fa_ops.flash_attention.launches_tensor_core = 0

    def counts():
        got = {name: fn.launches for name, fn in fns.items()}
        got["cfg_update_keyed"] = cfg_ops.cfg_update.launches_keyed
        got["flash_attention_short"] = fa_ops.flash_attention.launches_short
        return got

    # phase 4's plan: 15 waves of 120 rows, 50 steps each, the step noise
    # drawn in the update kernel, every attention on the short kernel
    L = dc.num_layers
    want9 = {"cfg_update": wave_steps, "flash_attention": wave_steps * L,
             "adaln_norm": wave_steps * (2 * L + 1), "cfg_update_rowwise": 0,
             "cfg_update_mixed": 0, "rmsnorm": 0,
             "cfg_update_keyed": wave_steps,
             "flash_attention_short": wave_steps * L}
    methods, launches9 = {}, {}

    def method_done(name, t, metrics, upload, want_upload, *,
                    exact_upload=True, **extra):
        """Check and record one method's run; a partial-participation
        run uploads at most what ``comm.upload_params`` counts."""
        accs = {k: metrics[k] for k in clients}
        check(sorted(metrics.keys() - {"history"}) == sorted(clients),
              f"{name}: metrics keys {sorted(metrics)}")
        check(all(0.0 <= a <= 1.0 for a in accs.values()),
              f"{name}: accuracies {accs}")
        check(upload == want_upload if exact_upload
              else 0 < upload <= want_upload,
              f"{name}: upload {upload}, comm.upload_params {want_upload}")
        methods[name] = dict(avg_accuracy=metrics["avg"], accuracies=accs,
                             upload_params=upload,
                             comm_upload_params=want_upload, wall_s=t,
                             **extra)
        say(f"[9] {name}: avg accuracy {metrics['avg']:.4f}, upload "
            f"{upload} parameters (comm.upload_params {want_upload}), "
            f"{t:.2f} s ({smi})")

    # 9.1 OSCAR, twice from one key
    oscar_mod.synthesize = staged(synthesize, "synthesis")
    oscar_mod.fit_global = staged(ct.fit_global, "training")
    runs9 = []
    try:
        for rnd in (1, 2):
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = oscar_mod.run_oscar(prng.PRNGKey(9), ocfg, data, model,
                                      sched, FrozenFM())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = counts()
            check(got == want9, f"9 OSCAR round {rnd}: launches {got} != "
                  f"phase 4's plan {want9}")
            runs9.append((res, wall))
    finally:
        oscar_mod.synthesize, oscar_mod.fit_global = synthesize, ct.fit_global
    launches9["oscar"] = got
    (res, wall), (res2, _) = runs9
    check(tuple(res.syn_images.shape) == (1800, 16, 16, 3)
          and bool(torch.isfinite(res.syn_images).all()),
          f"OSCAR D_syn {tuple(res.syn_images.shape)}")
    check(torch.equal(res.syn_images, res2.syn_images)
          and torch.equal(res.syn_labels, res2.syn_labels),
          "OSCAR D_syn differs between two runs from one key")
    p1, p2 = res.global_params.state_dict(), res2.global_params.state_dict()
    check(all(torch.equal(p1[k], p2[k]) for k in p1),
          "OSCAR global model differs between two runs from one key")
    clf_steps = ocfg.classifier_steps
    train_rates = [clf_steps / s_ for s_ in stage_s["training"]]
    # where a training step's time goes: 20 steps under the profiler,
    # against the same 20 steps untraced
    k20 = prng.PRNGKey(15)

    def train20():
        return ct.train_classifier(
            init_classifier(k20, "resnet18", C, device=dev), "resnet18",
            res.syn_images, res.syn_labels, k20, steps=20, batch=64)

    train20()
    torch.cuda.synchronize()
    t = time.perf_counter()
    train20()
    torch.cuda.synchronize()
    wall20 = time.perf_counter() - t
    trace9 = device_busy(train20, BUILD_DIR / "train_trace.json")
    trace9 = {k: v for k, v in trace9.items() if "flash" not in k}
    trace9["untraced_wall_s"] = wall20
    trace9["device_idle_share_of_untraced_wall"] = \
        1 - trace9["device_busy_s"] / wall20
    # whether training needs deterministic cuDNN: 20 steps twice with
    # cuDNN's own choice of algorithms
    ct.deterministic_cudnn = contextlib.nullcontext
    try:
        free9 = [train20().state_dict() for _ in range(2)]
    finally:
        ct.deterministic_cudnn = deterministic_cudnn
    trace9["default_cudnn_training_repeats_bitwise"] = all(
        torch.equal(free9[0][k], free9[1][k]) for k in free9[0])
    method_done("oscar", wall, res.metrics, res.upload_per_client,
                comm.upload_params("oscar", num_categories=C),
                synthesis_s=list(stage_s["synthesis"]),
                training_s=list(stage_s["training"]),
                training_steps_per_s=train_rates,
                training_peak_mib_above_start=[b / 2 ** 20
                                               for b in train_peak],
                training_trace_20_steps=trace9)
    say(f"[9] OSCAR, two runs from one key: synthesis "
        f"{stage_s['synthesis'][0]:.3f} / {stage_s['synthesis'][1]:.3f} s, "
        f"training {stage_s['training'][0]:.3f} / "
        f"{stage_s['training'][1]:.3f} s ({train_rates[0]:.1f} / "
        f"{train_rates[1]:.1f} steps/s, peak "
        f"{train_peak[0] / 2**20:.1f} / {train_peak[1] / 2**20:.1f} MiB above "
        f"the start); D_syn and global model bit-identical; launches "
        f"{launches9['oscar']} ({smi})")
    say(f"[9] 20 training steps traced: device busy "
        f"{trace9['device_busy_s']:.4f} s of {wall20:.4f} s untraced, "
        f"{trace9['kernels']} kernels, idle "
        f"{100 * trace9['device_idle_share_of_untraced_wall']:.1f}%; with "
        f"cuDNN's own algorithms two runs repeat bit for bit: "
        f"{trace9['default_cudnn_training_repeats_bitwise']}; top "
        f"device time (us) {trace9['top_device_us'][:4]} ({smi})")

    # 9.2 three SGD steps of train_classifier, card against CPU: one init,
    # one key, D_syn's first 512 rows.  A ReLU input on one side of 0 on
    # the card and on the other on the CPU moves the parameters by a step
    # (~1e-4), not by rounding.  A run's 6.3e6 ReLU inputs (39 calls) hold
    # one within 1e-6 of 0 as a rule (2.3e-7 in PR 20's runs), so no key is
    # kink-free as phase 3b's samples and the card test's data are.  The
    # gate takes the first of eight keys whose two runs put every ReLU input
    # on the same side of 0, where they compute the same function, and
    # prints each key's count of inputs that cross; a fault on the card
    # moves inputs in every key
    xs, ys = res.syn_images[:512], res.syn_labels[:512]

    def train3(kt, device):
        signs, margins = [], []

        def record(v):
            signs.append((v > 0).cpu())
            margins.append(float(v.abs().min()))

        with recorded_relu(record):
            out = ct.train_classifier(
                init_classifier(kt, "resnet18", C, device=device), "resnet18",
                xs.to(device), ys.to(device), kt, steps=3, batch=64)
        return out, signs, min(margins)

    crossed9 = {}
    for seed9 in range(10, 18):
        kt = prng.PRNGKey(seed9)
        card, signs_card, _ = train3(kt, dev)
        cpu, signs_cpu, margin9 = train3(kt, "cpu")
        check(len(signs_card) == len(signs_cpu),
              f"{len(signs_card)} ReLU calls on the card, "
              f"{len(signs_cpu)} on the CPU")
        crossed9[seed9] = sum(int((c != p).sum())
                             for c, p in zip(signs_card, signs_cpu))
        if crossed9[seed9] == 0:
            break
    check(crossed9[seed9] == 0, f"every key has ReLU inputs that cross 0 "
          f"between the card and the CPU: {crossed9}")
    pc, pg = cpu.state_dict(), card.state_dict()
    err_train = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in pc)
    moved = max(float((pc[k] - v).abs().max()) for k, v in init_classifier(
        kt, "resnet18", C, device="cpu").state_dict().items())
    with torch.no_grad():
        loss_card = float(ct.xent(card, "resnet18", xs, ys))
        loss_cpu = float(ct.xent(cpu, "resnet18", xs.cpu(), ys.cpu()))
    err_loss = abs(loss_card - loss_cpu)
    say(json.dumps({"train_card_vs_cpu": {
        "classifier": "resnet18", "steps": 3, "batch": 64,
        "params_max_abs_err": err_train, "params_moved": moved,
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "loss_abs_err": err_loss, "tol": TOL_TRAIN,
        "key": seed9, "relu_inputs_crossing_0_by_key": crossed9,
        "min_relu_margin_cpu": margin9, "card": smi}}))
    check(moved > 1e-2, f"vacuous training check: params moved {moved:.3g}")
    check(err_train <= TOL_TRAIN and err_loss <= TOL_TRAIN,
          f"train_classifier card vs CPU: params {err_train:.3g}, loss "
          f"{err_loss:.3g} (tol {TOL_TRAIN:g})")

    # 9.3 FedAvg at participation 0.5 (not a method of Table I); Table I's
    # methods run once, on the pre-trained DM, in phase 10
    n_clf = sum(p.numel() for p in res.global_params.parameters())
    t = time.perf_counter()
    _, m_fl, up = run_fl(prng.PRNGKey(12), data, method="fedavg", rounds=10,
                         local_steps=20, device=dev, participation=0.5)
    method_done("fedavg_participation_0.5", time.perf_counter() - t, m_fl,
                up, comm.upload_params("fedavg", num_categories=C,
                                       clf_params=n_clf, rounds=10),
                exact_upload=False)
    for kname in ("adaln_norm", "cfg_update_keyed", "flash_attention_short"):
        kernels[kname].setdefault("launches_phase9", {})["oscar"] = \
            launches9["oscar"][kname]
    t9 = time.perf_counter() - t9
    say(json.dumps({"methods": {
        "preset": "paper", "classifier": "resnet18",
        "dit": "init_dit(key 1) perturbed 0.05·normal",
        "methods": methods, "launches": launches9, "phase_s": t9,
        "card": smi}}))
    say(f"[9] run_oscar on a random DiT and FedAvg at participation 0.5: "
        f"{t9:.1f} s ({smi})")

    # -- 10. DM pretraining and Table I --------------------------------------
    # benchmarks/common.py's paper preset: phase 4's data with the DM's
    # pre-training pool (120 images a (category, domain), 7200), phase 3's
    # DiT pre-trained 6000 steps of 128, 30 samples a (client, category),
    # ResNet-18 trained 400 steps of 64, and the FL baselines at 20 rounds,
    # as benchmarks/table1_main.py runs them
    t10 = time.perf_counter()
    ocfg10 = OscarConfig(data=DataConfig(**PAPER_DATA, **PAPER_POOL),
                         diffusion=DiffusionConfig(**PAPER_DM), **PAPER_TOP)
    dc10 = ocfg10.diffusion
    check((dc10.d_model, dc10.num_layers, dc10.num_heads, dc10.patch,
           dc10.cond_dim) == (dc.d_model, dc.num_layers, dc.num_heads,
                              dc.patch, dc.cond_dim), "phase 10's DiT")

    # 10.1 initial weights from one key: the card's equal the CPU's
    k101 = prng.PRNGKey(101)
    init_pairs = [(init_dit(k101, dc10, 16, 3, device=d).state_dict()
                   for d in (dev, "cpu")),
                  (init_classifier(k101, "resnet18", C, device=d).state_dict()
                   for d in (dev, "cpu"))]
    for what, (on_card, on_cpu) in zip(("init_dit", "resnet18"),
                                       init_pairs):
        check(sorted(on_card) == sorted(on_cpu) and all(
            v.device.type == "cuda" and torch.equal(v.cpu(), on_cpu[k])
            for k, v in on_card.items()),
              f"{what} from one key: the card's weights differ from the "
              f"CPU's")
    say(f"[10.1] init_dit and resnet18 from one key: the card's weights "
        f"equal the CPU draws bit for bit")

    # the pool and its encodings, as Experiment builds them
    data10 = make_federated_data(ocfg10.data)
    pool_x = data10.pool_images
    groups10 = data10.pool_domains.astype(np.int64) * C + data10.pool_labels
    with torch.inference_mode():
        pool_y = FrozenFM()(torch.as_tensor(pool_x, device=dev)).cpu().numpy()

    # 10.2 two 50-step pretrainings from one key repeat bit for bit
    runs10 = [ddpm.pretrain_dm(prng.PRNGKey(102), dc10, pool_x, pool_y,
                               image_size=16, channels=3, steps=50,
                               groups=groups10, device=dev)
              for _ in range(2)]
    (m_a, _, l_a), (m_b, _, l_b) = runs10
    s_a, s_b = m_a.state_dict(), m_b.state_dict()
    moved50 = max(float((s_a[k] - v).abs().max()) for k, v in init_dit(
        prng.split(prng.PRNGKey(102))[0], dc10, 16, 3,
        device=dev).state_dict().items())
    check(l_a == l_b and all(torch.equal(s_a[k], s_b[k]) for k in s_a),
          "two 50-step pretrainings from one key differ")
    check(moved50 > 1e-3, f"vacuous pretraining repeat: moved {moved50:.3g}")
    say(f"[10.2] two 50-step pretrainings from one key: parameters and "
        f"losses bit-identical (loss {l_a[0][1]:.4f} → {l_a[-1][1]:.4f}, "
        f"weights moved up to {moved50:.3g})")
    del runs10, m_a, m_b, s_a, s_b

    # one training step's loss and gradients, card against CPU, on weights
    # perturbed 0.05·normal (adaLN-zero would zero every gradient but
    # patch_out's) and a batch of the pool
    m_cpu = init_dit(prng.PRNGKey(103), dc10, 16, 3, device="cpu")
    rng103 = np.random.default_rng(103)
    with torch.no_grad():
        for p in m_cpu.parameters():
            p.add_(0.05 * torch.from_numpy(rng103.standard_normal(
                tuple(p.shape), dtype=np.float32)))
    m_card = copy.deepcopy(m_cpu).to(dev)
    b10 = np.arange(128) * (len(pool_x) // 128)
    gm10 = ddpm.group_means(pool_y, groups10)
    step_out = {}
    for where, m in (("cpu", m_cpu), ("card", m_card)):
        m.plain = True
        loss = ddpm.diffusion_loss(
            m, dc10, make_schedule(1000, device=where if where == "cpu"
                                   else dev),
            pool_x[b10], pool_y[b10], prng.PRNGKey(104), gm10[b10])
        grads = torch.autograd.grad(loss, list(m.parameters()))
        step_out[where] = (float(loss.detach()),
                           [g.detach().cpu() for g in grads])
    err_dm_loss = abs(step_out["card"][0] - step_out["cpu"][0])
    err_dm_grad = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(step_out["card"][1], step_out["cpu"][1]))
    say(json.dumps({"dm_step_card_vs_cpu": {
        "batch": 128, "loss_card": step_out["card"][0],
        "loss_cpu": step_out["cpu"][0], "loss_abs_err": err_dm_loss,
        "loss_tol": TOL_DM_LOSS, "grad_max_rel_err": err_dm_grad,
        "grad_rel_tol": TOL_DM_GRAD, "card": smi}}))
    check(min(float(g.abs().max()) for g in step_out["cpu"][1]) > 0,
          "vacuous DM gradient check: a parameter's gradient is 0")
    check(err_dm_loss <= TOL_DM_LOSS and err_dm_grad <= TOL_DM_GRAD,
          f"DM training step card vs CPU: loss {err_dm_loss:.3g}, gradients "
          f"{err_dm_grad:.3g} relative")
    del m_cpu, m_card, step_out

    # 10.3 Experiment pre-trains the DM into a fresh cache directory
    cache10 = BUILD_DIR / "dm_cache_smoke"
    shutil.rmtree(cache10, ignore_errors=True)
    pre = {}

    def timed_pretrain(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = ddpm.pretrain_dm(*args, **kwargs)
        torch.cuda.synchronize()
        pre.update(s=time.perf_counter() - t,
                   peak_mib=(torch.cuda.max_memory_allocated() - base)
                   / 2**20)
        return out

    exp_mod.pretrain_dm = timed_pretrain
    try:
        exp = exp_mod.Experiment(ocfg10, verbose=False, cache_dir=cache10,
                                 device=dev)
    finally:
        exp_mod.pretrain_dm = ddpm.pretrain_dm
    losses10 = [v for _, v in exp.dm_losses]
    check(len(losses10) == dc10.pretrain_steps
          and all(math.isfinite(v) for v in losses10),
          f"{len(losses10)} pretraining losses")
    first100, last100 = (float(np.mean(losses10[:100])),
                         float(np.mean(losses10[-100:])))
    fall10 = first100 / last100
    # where a pretraining step's time goes: pretrain_dm itself for 20 steps
    # (its set-up included: the init's draws, the pool's copy to the card,
    # the group means), once untraced and once under the profiler
    def pretrain20():
        ddpm.pretrain_dm(prng.PRNGKey(105), dc10, pool_x, pool_y,
                         image_size=16, channels=3, steps=20,
                         groups=groups10, device=dev)

    torch.cuda.synchronize()
    t = time.perf_counter()
    pretrain20()
    torch.cuda.synchronize()
    wall20p = time.perf_counter() - t
    trace10 = device_busy(pretrain20, BUILD_DIR / "pretrain_trace.json")
    trace10 = {k: v for k, v in trace10.items() if "flash" not in k}
    trace10["untraced_wall_s"] = wall20p
    trace10["device_idle_share_of_untraced_wall"] = \
        1 - trace10["device_busy_s"] / wall20p
    pretrain10 = dict(
        steps=dc10.pretrain_steps, batch=dc10.batch_size, seconds=pre["s"],
        steps_per_s=dc10.pretrain_steps / pre["s"],
        peak_mib_above_start=pre["peak_mib"], loss_first_100=first100,
        loss_last_100=last100, loss_fall=fall10,
        loss_fall_gate=LOSS_FALL, tag=exp.tag,
        traced_20_steps=trace10, card=smi)
    say(json.dumps({"pretrain": pretrain10}))
    say(f"[10.3] DM pre-trained: {dc10.pretrain_steps} steps of "
        f"{dc10.batch_size} in {pre['s']:.2f} s "
        f"({dc10.pretrain_steps / pre['s']:.1f} steps/s), peak "
        f"{pre['peak_mib']:.1f} MiB above the start; loss first 100 "
        f"{first100:.4f}, last 100 {last100:.4f} (fell {fall10:.2f}x, gate "
        f"{LOSS_FALL:g}x); pretrain_dm for 20 steps, traced: device busy "
        f"{trace10['device_busy_s']:.4f} s of {wall20p:.4f} s untraced, "
        f"{trace10['kernels']} kernels, idle "
        f"{100 * trace10['device_idle_share_of_untraced_wall']:.1f}% ({smi})")
    check(fall10 >= LOSS_FALL, f"pretraining loss fell {fall10:.3g}x, "
          f"below the predicted {LOSS_FALL:g}x")

    # 10.4 a second Experiment of the same config loads the checkpoint
    exp2 = exp_mod.Experiment(ocfg10, verbose=False, cache_dir=cache10,
                              device=dev)
    w1, w2 = exp.dm.state_dict(), exp2.dm.state_dict()
    check(exp2.dm_losses == [] and sorted(w1) == sorted(w2)
          and all(torch.equal(w1[k], w2[k]) for k in w1),
          "the DM loaded from the checkpoint differs from the trained one")
    say(f"[10.4] the DM reloaded from {cache10.name}/{exp.tag}: weights "
        f"bit-equal to the trained DM's")
    del exp2, w1, w2

    # 10.5 one DiT call on the trained weights, kernel route against plain
    plain10 = copy.deepcopy(exp.dm)
    plain10.plain = True
    x105, y105 = randn(256, 16, 16, 3), torch.as_tensor(pool_y[:256],
                                                        device=dev)
    t105 = torch.randint(0, 1000, (256,), generator=g, device=dev)
    with torch.inference_mode():
        for y_in in (y105, None):
            ref = plain10(x105, t105, y_in)
            out = exp.dm(x105, t105, y_in)
            err = max_err(out, ref)
            check(float(ref.abs().max()) > 1e-2, "vacuous trained-DiT parity")
            check(err <= TOL_DIT, f"trained DiT kernel vs plain {err:.3g}")
            say(f"[10.5] trained DiT B=256 y="
                f"{'given' if y_in is not None else 'null'}: max|ref| "
                f"{float(ref.abs().max()):.3f}, kernel vs plain max_abs_err "
                f"{err:.3g} (tol {TOL_DIT:g})")
    del plain10

    # 10.6 Table I: the seven methods on the trained DM.  Launch counts
    # against the plans: OSCAR's and FedDISC's D_syn phase 4's 15 waves of
    # 120, FedCADO's grouped classifier-guided waves the plain ancestral
    # step (a client's 300 rows make 3 waves of 104), the FL baselines none
    cado_steps = R * 3 * num_steps
    want_cado = dict(want9, cfg_update=0, cfg_update_keyed=0,
                     flash_attention=cado_steps * L,
                     flash_attention_short=cado_steps * L,
                     adaln_norm=cado_steps * (2 * L + 1))
    want10 = dict(oscar=want9, feddisc=want9, fedcado=want_cado)
    dsyn10 = {}

    def kept_dsyn(fn, name):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            dsyn10[name] = out[3][0]
            return out
        return call

    for k in stage_s:
        stage_s[k].clear()
    def kept_oscar(*args, **kwargs):
        res = oscar_mod.run_oscar(*args, **kwargs)
        dsyn10["oscar"] = res.syn_images
        return res

    exp_mod.run_fedcado = kept_dsyn(run_fedcado, "fedcado")
    exp_mod.run_feddisc = kept_dsyn(run_feddisc, "feddisc")
    exp_mod.run_oscar = kept_oscar
    dm_mod.train_classifier = staged(ct.train_classifier, "training")
    dm_mod.fit_global = staged(ct.fit_global, "training")
    table1, launches10 = {}, {}
    try:
        for m in exp_mod.ALL_METHODS:
            stage_s["training"].clear()
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = exp.run(m, rounds=20)
            wall = time.perf_counter() - t
            launches10[m] = got = counts()
            plan = want10.get(m, {k: 0 for k in want9})
            check(got == plan, f"10 {m}: launches {got} != plan {plan}")
            check(sorted(out.keys() - {"history", "upload_params", "method",
                                       "wall_s"}) == sorted(clients),
                  f"{m}: result keys {sorted(out)}")
            accs = {k: out[k] for k in clients}
            check(all(0.0 <= a <= 1.0 for a in accs.values()),
                  f"{m}: accuracies {accs}")
            want_up = comm.upload_params(m, num_categories=C,
                                         clf_params=n_clf, rounds=20)
            check(out["upload_params"] == want_up, f"{m}: upload "
                  f"{out['upload_params']}, comm.upload_params {want_up}")
            row = dict(avg_accuracy=out["avg"], accuracies=accs,
                       upload_params=out["upload_params"], wall_s=wall)
            if m in dsyn10:
                x_m = dsyn10[m]
                check(tuple(x_m.shape) == (1800, 16, 16, 3)
                      and bool(torch.isfinite(x_m).all()), f"{m} D_syn")
            if m in ("fedcado", "feddisc"):
                train_s = sum(stage_s["training"])
                row.update(training_s=train_s, other_s=wall - train_s)
            table1[m] = row
            say(f"[10.6] {m}: avg accuracy {out['avg']:.4f}, per client "
                f"{[round(accs[f'client{r + 1}'], 4) for r in range(R)]}, "
                f"upload {out['upload_params']} parameters, {wall:.2f} s "
                f"({smi})")
    finally:
        exp_mod.run_fedcado, exp_mod.run_feddisc = run_fedcado, run_feddisc
        exp_mod.run_oscar = oscar_mod.run_oscar
        dm_mod.train_classifier = ct.train_classifier
        dm_mod.fit_global = ct.fit_global
    for name, got in launches10.items():
        for kname in ("adaln_norm", "cfg_update_keyed",
                      "flash_attention_short"):
            kernels[kname].setdefault("launches_phase10", {})[name] = \
                got[kname]
    oscar_avg = table1["oscar"]["avg_accuracy"]
    best_base = max(v["avg_accuracy"] for k, v in table1.items()
                    if k != "oscar")
    say(f"[10.6] OSCAR avg {oscar_avg * 100:.2f}% vs best baseline "
        f"{best_base * 100:.2f}% -> "
        f"{'BEATS' if oscar_avg >= best_base else 'below'}")
    t10 = time.perf_counter() - t10
    say(json.dumps({"table1": {
        "preset": "paper", "classifier": "resnet18",
        "dit": f"pre-trained {dc10.pretrain_steps} steps", "rounds": 20,
        "methods": table1, "launches": launches10, "phase_s": t10,
        "card": smi}}))
    check(oscar_avg > 1.0 / C, f"OSCAR avg accuracy {oscar_avg:.4f} is not "
          f"above chance ({1.0 / C:.4f})")
    say(f"[10] DM pretraining and Table I: {t10:.1f} s ({smi})")

    # -- 11. the D_syn front door: service, store, cache, streaming, faults --
    # on phase 10's trained DM.  Every drain's launches are checked against
    # a plan: a uniform wave-step launches cfg_update (keyed) once, a
    # ragged one cfg_update_rowwise, a mixed one cfg_update_mixed, and each
    # of them L flash attentions (the short kernel) and 2L + 1 adaln_norms
    t11 = time.perf_counter()
    launches11 = {}
    keyed_fns = {"cfg_update_keyed": cfg_ops.cfg_update,
                 "cfg_update_rowwise_keyed": cfg_ops.cfg_update_rowwise,
                 "cfg_update_mixed_keyed": cfg_ops.cfg_update_mixed}

    def zero11():
        zero_counts()
        for fn in keyed_fns.values():
            fn.launches_keyed = 0

    def counts11():
        got = counts()
        got.update({k: fn.launches_keyed for k, fn in keyed_fns.items()})
        return got

    def plan11(uniform=0, rowwise=0, mixed=0):
        iters = uniform + rowwise + mixed
        return {"cfg_update": uniform, "flash_attention": iters * L,
                "adaln_norm": iters * (2 * L + 1),
                "cfg_update_rowwise": rowwise, "cfg_update_mixed": mixed,
                "rmsnorm": 0, "cfg_update_keyed": uniform,
                "flash_attention_short": iters * L,
                "cfg_update_rowwise_keyed": rowwise,
                "cfg_update_mixed_keyed": mixed}

    walls11 = {}

    def planned(name, plan, fn):
        """Run ``fn`` with every count at 0, time it by the host clock to
        the end of its device work, and check its launches."""
        zero11()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls11[name] = time.perf_counter() - t
        launches11[name] = got = counts11()
        check(got == plan, f"11 {name}: launches {got} != plan {plan}")
        return out

    def sha(x) -> str:
        return hashlib.sha256(x.float().cpu().numpy().tobytes()).hexdigest()

    def delta(eng, before):
        after = eng.stats
        return {k: after[k] - before[k] for k in
                ("waves", "generated", "padded", "cache_hits", "store_hits",
                 "streamed", "row_iters_scheduled", "row_iters_active")}

    uniform_steps = 15 * num_steps        # phase 4's 15 waves of 120
    none = plan11()
    report11 = {}

    # 11.1 a repeated run is served from the shared service's row cache:
    # no wave, no launch, the same D_syn and the same accuracies
    rep = {}
    for m in ("oscar", "feddisc"):
        before = exp.engine.stats
        out = planned(f"repeat_{m}", none, lambda: exp.run(m, rounds=20))
        d = delta(exp.engine, before)
        check(d["waves"] == 0 and d["cache_hits"] == 1800
              and d["store_hits"] == 0, f"11.1 {m} repeat: {d}")
        accs = {k: out[k] for k in clients}
        check(accs == table1[m]["accuracies"],
              f"11.1 {m} repeat: accuracies {accs} != Table I's "
              f"{table1[m]['accuracies']}")
        rep[m] = dict(stats=d, avg_accuracy=out["avg"], wall_s=out["wall_s"])
        say(f"[11.1] {m} again: {d['cache_hits']} rows from the row cache, "
            f"{d['waves']} waves, 0 launches, avg accuracy {out['avg']:.4f} "
            f"== Table I's, {out['wall_s']} s ({smi})")
    report11["repeats"] = rep

    # 11.2 a cold process on the same cache_dir: the DM from the
    # checkpoint, D_syn from the store, no wave and no launch
    digests10 = {m: sha(dsyn10[m]) for m in ("oscar", "feddisc")}
    t = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", STORE_CHILD, str(cache10)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    check(child.returncode == 0, f"11.2 store child process: {child.stderr}")
    cold = json.loads(child.stdout.strip().splitlines()[-1])
    for m in ("oscar", "feddisc"):
        c = cold[m]
        check(c["waves"] == 0 and c["store_hits"] == 1800
              and c["launches"] == 0, f"11.2 {m} cold process: {c}")
        check(c["sha256"] == digests10[m], f"11.2 {m}: D_syn sha256 "
              f"{c['sha256']} != Table I's {digests10[m]}")
        check(c["accuracies"] == table1[m]["accuracies"],
              f"11.2 {m}: accuracies {c['accuracies']} != Table I's")
        say(f"[11.2] {m} in a cold process: {c['store_hits']} rows from the "
            f"store, 0 waves, 0 launches, D_syn sha256 {c['sha256']} == "
            f"Table I's, avg accuracy {c['avg']:.4f} == Table I's")
    report11["cold_process"] = dict(cold, wall_s=time.perf_counter() - t)

    # 11.3 top-up: phase 4's uploads at 20 samples, then at 30 on a fresh
    # store: the second drain draws the 10 missing rows of each and no more
    store113 = BUILD_DIR / "dsyn_store_11_3"
    shutil.rmtree(store113, ignore_errors=True)
    svc = SynthesisService(
        SynthesisEngine(exp.dm, exp.sched, image_size=16, wave_size=wave),
        key=prng.PRNGKey(113), store=SynthesisStore(store113))
    rows113, top = [], {}
    for n, waves113 in ((20, 10), (30, 5)):
        before = svc.engine.stats

        def drain113():
            futs = [svc.submit(enc[r, c], c, n) for r, c in uploads]
            return svc.gather(futs)

        rows113.append(planned(f"top_up_{n}",
                               plan11(uniform=waves113 * num_steps),
                               drain113))
        top[n] = delta(svc.engine, before)
    check(top[30]["generated"] == 600 and top[30]["cache_hits"] == 1200
          and top[20]["generated"] == 1200,
          f"11.3 top-up drew {top[30]['generated']} rows, want 600: {top}")
    check(all(torch.equal(b[:20], a) for a, b in zip(*rows113))
          and all(len(b) == 30 for b in rows113[1]),
          "11.3: the first 20 rows of a topped-up request differ")
    report11["top_up"] = dict(stats=top, store_entries=svc.stats[
        "store_entries"])
    say(f"[11.3] top-up 20 -> 30 samples: the second drain drew "
        f"{top[30]['generated']} rows in {top[30]['waves']} waves and served "
        f"{top[30]['cache_hits']} from the cache; the first 20 rows of all "
        f"60 requests bit-equal")

    # 11.4 streaming admission: phase 6's mixed (guidance, steps) uploads,
    # ragged, 10 submitted before the drain and 10 more at each wave
    # boundary, against a snapshot drain of the same requests.  Waves of
    # 120 rows, so both drains pack the same waves (cuBLAS does not promise
    # a row the same bits in a batch of another size)
    key114 = prng.PRNGKey(114)

    def service114():
        return SynthesisService(SynthesisEngine(
            exp.dm, exp.sched, image_size=16, wave_size=120, ragged=True))

    def submit114(svc, ids):
        return [svc.submit(enc[uploads[i][0], uploads[i][1]],
                           uploads[i][1], k_samples,
                           guidance=combos[i % 4][0],
                           num_steps=combos[i % 4][1]) for i in ids]

    stream_modes = {}
    snap = service114()
    want114 = planned("snapshot", plan11(rowwise=ragged_iters6),
                      lambda: snap.gather(submit114(snap, range(60)),
                                          key114))
    stream = service114()
    futs114 = submit114(stream, range(10))
    pending = list(range(10, 60))

    def poll():
        if pending:
            futs114.extend(submit114(stream, pending[:10]))
            del pending[:10]
        return bool(pending)

    planned("streaming", plan11(rowwise=ragged_iters6),
            lambda: stream.drain(key114, poll=poll))
    check(all(torch.equal(f.result(), w) for f, w in zip(futs114, want114)),
          "11.4: streamed D_syn differs from the snapshot drain's")
    for name, svc in (("snapshot", snap), ("streaming", stream)):
        st = svc.stats
        stream_modes[name] = {k: st[k] for k in (
            "waves", "streamed", "padded", "row_iters_scheduled",
            "row_iters_active")}
    check(stream_modes["streaming"]["streamed"] == 50
          and stream_modes["snapshot"]["streamed"] == 0,
          f"11.4 streamed counts {stream_modes}")
    report11["streaming"] = stream_modes
    say(f"[11.4] streaming vs snapshot (60 ragged uploads, 1800 rows): "
        f"D_syn bit-identical; {json.dumps(stream_modes)}")

    # 11.5 tracing: one uniform round with a tracer on and one with it off,
    # the same D_syn; the trace exported and validated
    key115 = prng.PRNGKey(115)

    def uniform_round(tag, svc):
        return planned(tag, plan11(uniform=uniform_steps), lambda: torch.cat(
            svc.gather([svc.submit(enc[r, c], c, k_samples)
                        for r, c in uploads], key115)))

    tracer = Tracer()
    traced_svc = SynthesisService(SynthesisEngine(
        exp.dm, exp.sched, image_size=16, wave_size=wave), tracer=tracer)
    traced = uniform_round("traced", traced_svc)
    plain115 = uniform_round("untraced", SynthesisService(SynthesisEngine(
        exp.dm, exp.sched, image_size=16, wave_size=wave)))
    check(torch.equal(traced, plain115),
          "11.5: D_syn differs with tracing on")
    trace_obj = write_trace(BUILD_DIR / "service_trace.json", tracer,
                            registry=traced_svc.engine.metrics)
    n_events = validate_chrome_trace(trace_obj)
    spans = {}
    for sp in tracer.spans:
        spans[sp.name] = spans.get(sp.name, 0) + 1
    lat = traced_svc.stats["latency"]
    check(spans.get("wave.dispatch") == 15 and spans.get("device.scan") == 15
          and lat["e2e_latency"]["count"] == 60,
          f"11.5 spans {spans}, latency {lat}")
    report11["tracing"] = dict(spans=spans, events=n_events, latency=lat)
    say(f"[11.5] tracing on vs off: D_syn bit-identical; "
        f"build/service_trace.json, {n_events} events valid; spans {spans}; "
        f"queue wait p50 {lat['queue_wait']['p50']:.4g} s p99 "
        f"{lat['queue_wait']['p99']:.4g} s, end to end p50 "
        f"{lat['e2e_latency']['p50']:.4g} s p99 "
        f"{lat['e2e_latency']['p99']:.4g} s ({smi})")

    # 11.6 fault drills.  (a) transient faults at the fence of waves 0, 3
    # and 7 (wave 7 twice) retry under RetryPolicy: 11.5's D_syn
    slept = []
    faulty = SynthesisService(
        SynthesisEngine(exp.dm, exp.sched, image_size=16, wave_size=wave),
        faults=FaultInjector([("scan", 0, 0), ("scan", 0, 3),
                              ("scan", 0, 7), ("scan", None, 7)]),
        retry=RetryPolicy(sleep=slept.append))
    got = uniform_round("faults_scan", faulty)
    m = faulty.engine.metrics
    retries = m.get("retry.attempts", site="device.scan")
    check(torch.equal(got, plain115) and retries == 4
          and m.get("fault.injected", site="scan") == 4,
          f"11.6a: D_syn equal {torch.equal(got, plain115)}, "
          f"{retries} retries")
    say(f"[11.6a] 4 transient fence faults: {retries} retries (backoff "
        f"{slept} s), D_syn bit-identical to the fault-free round")

    # (b) a poisoned classifier closure beside a healthy classifier-guided
    # tenant on a ragged service: 10 uploads (300 rows), two healthy
    # classifier-guided requests of 30 (phase 7's first classifier, 25
    # steps), then two poisoned ones.  Three waves of 120, the last mixed
    def poisoned(x, labels):
        raise RuntimeError("poisoned classifier closure")

    key116 = prng.PRNGKey(116)

    def tenants(svc, with_poison):
        futs = [svc.submit(enc[r, c], c, k_samples) for r, c in uploads[:10]]
        futs += [svc.submit_classifier_guided(clfs[0], c, k_samples,
                                              guidance=1.0, num_steps=25)
                 for c in (1, 2)]
        if with_poison:
            futs += [svc.submit_classifier_guided(poisoned, c, k_samples)
                     for c in (3, 4)]
        return svc.gather(futs, key116, return_exceptions=True)

    plan116 = plan11(rowwise=2 * num_steps, mixed=num_steps)
    outs116 = {}
    for with_poison in (True, False):
        svc = SynthesisService(SynthesisEngine(
            exp.dm, exp.sched, image_size=16, wave_size=wave, ragged=True))
        outs116[with_poison] = planned(
            f"faults_poisoned_{with_poison}", plan116,
            lambda: tenants(svc, with_poison))
        if with_poison:
            failed116 = svc.engine.metrics.get("requests_failed")
    bad = outs116[True][12:]
    check(all(isinstance(e, RequestFailedError) for e in bad)
          and failed116 == 2, f"11.6b poisoned requests resolved to {bad}")
    check(all(torch.equal(a, b) for a, b in zip(outs116[True][:12],
                                                 outs116[False])),
          "11.6b: the healthy tenants' D_syn differs beside the poisoned one")
    say(f"[11.6b] poisoned closure: 2 requests -> RequestFailedError, the "
        f"healthy 12 (10 uploads, 2 classifier-guided in a mixed wave) "
        f"bit-identical to a drain without it")

    # (c) a truncated store shard: quarantined and regenerated, bit for bit
    # (ragged rows keyed by identity, one request a 32-row wave)
    store116 = BUILD_DIR / "dsyn_store_11_6"
    shutil.rmtree(store116, ignore_errors=True)

    def stored():
        svc = SynthesisService(SynthesisEngine(
            exp.dm, exp.sched, image_size=16, wave_size=32, ragged=True),
            store=SynthesisStore(store116))
        return svc, svc.gather([svc.submit(enc[r, c], c, 32)
                                for r, c in uploads[:10]], key116)

    _, first116 = planned("faults_store_fill",
                          plan11(rowwise=10 * num_steps), stored)
    shard = sorted((store116 / "shards").glob("*.npz"))[3]
    shard.write_bytes(shard.read_bytes()[:1000])
    svc, again116 = planned("faults_store_heal", plan11(rowwise=num_steps),
                            stored)
    st = svc.engine.metrics
    check(all(torch.equal(a, b) for a, b in zip(first116, again116))
          and st.get("store.quarantined") == 1
          and svc.stats["store_hits"] == 9 * 32
          and (store116 / "quarantine" / shard.name).exists(),
          f"11.6c: quarantined {st.get('store.quarantined')}, store hits "
          f"{svc.stats['store_hits']}")
    say(f"[11.6c] truncated shard {shard.name}: quarantined, its request "
        f"regenerated in 1 wave bit-identical, 9 served from the store")
    report11["faults"] = dict(scan_retries=retries, backoff_s=slept,
                              poisoned_failed=failed116,
                              quarantined=st.get("store.quarantined"))

    for name, got in launches11.items():
        for kname in ("adaln_norm", "cfg_update_keyed",
                      "flash_attention_short", "cfg_update_rowwise_keyed",
                      "cfg_update_mixed_keyed"):
            kernels[kname].setdefault("launches_phase11", {})[name] = \
                got[kname]
    t11 = time.perf_counter() - t11
    say(json.dumps({"front_door": dict(report11, launches=launches11,
                                       walls_s=walls11, phase_s=t11,
                                       card=smi)}))
    say(f"[11] wall seconds by drain: "
        f"{ {k: round(v, 3) for k, v in walls11.items()} } ({smi})")
    say(f"[11] the D_syn front door: {t11:.1f} s ({smi})")
    # -- 12. placed multi-host drains ----------------------------------------
    # on phase 10's trained DM: phase 6's mixed (guidance, steps) uploads
    # over simulated hosts, each host's windows on a CUDA stream of its
    # own; every drain's launches against a plan computed from the
    # placements it made (each window runs its own segment chain: a
    # rowwise or mixed update, L short-kernel attentions and 2L + 1
    # adaln_norms an iteration), and the windows past the first of a wave
    # counted by the update kernels' launches at a non-zero row_offset
    t12 = time.perf_counter()
    launches12, walls12, report12 = {}, {}, {}
    offset_fns = {"cfg_update_rowwise_offset": cfg_ops.cfg_update_rowwise,
                  "cfg_update_mixed_offset": cfg_ops.cfg_update_mixed}
    key12 = prng.PRNGKey(12)

    def engine12(**kw):
        kw.setdefault("ragged", True)
        return SynthesisEngine(exp.dm, exp.sched, image_size=16,
                               wave_size=120, **kw)

    def submit12(eng, ids):
        return [eng.submit(enc[uploads[i][0], uploads[i][1]], uploads[i][1],
                           k_samples, guidance=combos[i % 4][0],
                           num_steps=combos[i % 4][1]) for i in ids]

    def recorded(eng):
        """Keep every placed wave the engine dispatches: its placement,
        its step ceiling, and each window's rows' step counts (padding
        repeats a window's last row), for the launch plan."""
        waves = []
        inner = eng._sample_wave_placed

        def call(parts_h, placement, key, max_steps, wave=-1):
            out = inner(parts_h, placement, key, max_steps, wave=wave)
            steps = []
            for w in placement.windows:
                s = [p.req.num_steps for p, t, _ in parts_h[w.host]
                     for _ in range(t)]
                steps.append(s + [s[-1]] * (w.rows - w.real))
            waves.append((placement, max_steps, steps,
                          any(p.req.mode == "clf" for parts in parts_h
                              for p, _, _ in parts)))
            return out

        eng._sample_wave_placed = call
        return waves

    def replayed(eng):
        """Keep each placed window's rows as the unplaced compacted sampler
        needs them (window order, padding included) with their identities
        (rid, row index), to replay after the drain: its launches stay out
        of the drain's counted run."""
        wins = []
        inner = eng._sample_wave_placed

        def call(parts_h, placement, key, max_steps, wave=-1):
            for w in placement.windows:
                parts = parts_h[w.host]
                rows = np.concatenate([p.row_block(t, s, eng._null_row)
                                       for p, t, s in parts])
                ids = [(p.req.rid, p.req.count - p.fresh + s + i,
                        p.req.guidance, p.req.num_steps)
                       for p, t, s in parts for i in range(t)]
                pad = w.rows - w.real
                rows = np.concatenate([rows, np.repeat(rows[-1:], pad, 0)])
                wins.append((rows, ids + [ids[-1]] * pad, w.real,
                             np.asarray(key), max_steps))
            return inner(parts_h, placement, key, max_steps, wave=wave)

        eng._sample_wave_placed = call
        return wins

    def replay12(wins, rids, counts):
        """Every recorded window sampled again alone by
        ``sample_cfg_compacted`` with the window's own activation plan (the
        batches the placed window ran), its rows back in request order."""
        rows = {}
        for cond, ids, real, key, smax in wins:
            rid, ridx, g, steps = (np.array(c) for c in zip(*ids))
            steps = steps.astype(np.int32)
            keys = prng.fold_in(prng.fold_in(key[None], rid), ridx)
            x = sample_cfg_compacted(
                exp.dm, exp.sched, cond, keys, g.astype(np.float32), steps,
                max_steps=smax, image_size=16,
                plan=guid.plan_epochs(steps, smax, compaction="full"))
            for i in range(real):
                rows[(int(rid[i]), int(ridx[i]))] = x[i]
        return torch.stack([rows[(r, i)] for r, n in zip(rids, counts)
                            for i in range(n)])

    def plan12(waves, compacted):
        """Launches a drain's placed waves imply: per window, its iterations
        (the step ceiling, or the epochs of its own activation plan) of
        the rowwise update, or the mixed one in a wave with a classifier-
        guided row; those of windows at a non-zero offset again on the
        offset counters."""
        it = {"rowwise": 0, "mixed": 0, "rowwise_off": 0, "mixed_off": 0}
        for placement, smax_w, steps, mixed in waves:
            for w, s in zip(placement.windows, steps):
                n = (sum(e - b for _, b, e in guid.plan_epochs(
                    np.asarray(s, np.int32), smax_w, compaction="full")[1])
                     if compacted else smax_w)
                kind = "mixed" if mixed else "rowwise"
                it[kind] += n
                if w.offset:
                    it[kind + "_off"] += n
        want = plan11(rowwise=it["rowwise"], mixed=it["mixed"])
        want.update(cfg_update_rowwise_offset=it["rowwise_off"],
                    cfg_update_mixed_offset=it["mixed_off"])
        return want

    def drain12(name, fn, plan_of=None):
        """Run ``fn`` with every count at 0, time it to the end of its device
        work, and check its launches against ``plan_of()`` (read after the
        run: the placements it made)."""
        zero11()
        for f in offset_fns.values():
            f.launches_offset = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls12[name] = time.perf_counter() - t
        got = counts11()
        got.update({k: f.launches_offset for k, f in offset_fns.items()})
        launches12[name] = got
        if plan_of is not None:
            want = plan_of()
            check(got == want, f"12 {name}: launches {got} != plan {want}")
        return out

    def per_host_sums(eng, what):
        s = eng.stats
        per = s["per_host"]
        check(all(sum(p[k] for p in per) == s[g] for k, g in (
            ("rows", "generated"), ("padded", "padded"),
            ("row_iters_scheduled", "row_iters_scheduled"),
            ("row_iters_active", "row_iters_active")))
              and s["scheduled_rows"] == s["generated"] + s["padded"],
              f"12 {what}: per-host sums {per} against {s}")
        return {k: s[k] for k in ("waves", "generated", "padded",
                                  "scheduled_rows", "row_iters_scheduled",
                                  "row_iters_active")}

    # the gates across packings.  A window is a batch of another size than
    # a wave, and cuBLAS promises a row no bits across batch sizes; the
    # first step of every trajectory (t = 999) divides ε̂ by √ᾱ_999 =
    # 4.9e-5 and guidance multiplies a difference by 1 + 2s, so on the
    # trained DM at s = 7.5 a rounding difference can move a 25- or
    # 50-step row far past 2e-2.  Each row is held at TOL_E2E_DEEP or, if
    # any row is over it, at max(TOL_E2E_DEEP, K_PROBE × how far two
    # probes (every DiT output moved by ± phase 3's kernel-vs-plain
    # difference, both signs) move that row in the unplaced drain): the
    # rule phases 4 and 6 hold 4-step rows to (``row_gated``).  K_PROBE was
    # calibrated on 4-step rows of a random DiT, and a row whose probe
    # movement reaches 0.5 gets a gate past the clipped range [-1, 1]:
    # such a row is not checked by its value at all.  So at most
    # MAX_SHARE_OVER_DEEP of a drain's rows may be over TOL_E2E_DEEP,
    # whatever their gates (measured: 12 of 1800, all in the compacted
    # H = 2 drain, whose windows the replay in 12.1 holds bit for bit),
    # and the rows gated by the probe, and those gated past the value
    # range, are counted and printed
    MAX_SHARE_OVER_DEEP = 0.02

    def gated12(what, got, ref, movement):
        err = (got - ref).abs().flatten(1).amax(1)
        over = err > TOL_E2E_DEEP
        out = dict(max_abs_err=float(err.max()),
                   rows=int(err.numel()),
                   rows_over_tol_e2e=int((err > TOL_E2E).sum()),
                   rows_over_tol_e2e_deep=int(over.sum()),
                   rows_probe_gated=0, rows_gated_past_value_range=0,
                   bit_identical=bool(torch.equal(got, ref)))
        check(out["rows_over_tol_e2e_deep"]
              <= MAX_SHARE_OVER_DEEP * out["rows"],
              f"{what}: {out['rows_over_tol_e2e_deep']} of {out['rows']} "
              f"rows over {TOL_E2E_DEEP:g}, more than "
              f"{MAX_SHARE_OVER_DEEP:.0%}")
        if bool(over.any()):
            moved = movement()
            gate = torch.clamp(K_PROBE * moved, min=TOL_E2E_DEEP)
            bad = (err > gate).nonzero().flatten().tolist()
            check(not bad, f"{what}: rows {bad[:8]} off by "
                  f"{err[bad][:8].tolist()} over their gates "
                  f"{gate[bad][:8].tolist()} (probes moved them "
                  f"{moved[bad][:8].tolist()})")
            out["rows_probe_gated"] = int((gate > TOL_E2E_DEEP).sum())
            out["rows_gated_past_value_range"] = int((gate >= 2.0).sum())
            rows = over.nonzero().flatten().tolist()
            out["rows_over_tol_e2e_deep_err_and_probe"] = [
                (r, float(err[r]), float(moved[r])) for r in rows]
        say(f"[12] {what}: max_abs_err {out['max_abs_err']:.3g}, rows over "
            f"{TOL_E2E:g} {out['rows_over_tol_e2e']}, over "
            f"{TOL_E2E_DEEP:g} {out['rows_over_tol_e2e_deep']} of "
            f"{out['rows']} "
            f"{out.get('rows_over_tol_e2e_deep_err_and_probe', '')} (gate "
            f"max({TOL_E2E_DEEP:g}, {K_PROBE:g}·probe), probe "
            f"±{dit_err:.2g}; rows gated by the probe "
            f"{out['rows_probe_gated']}, past the value range "
            f"{out['rows_gated_past_value_range']}), bit-identical "
            f"{out['bit_identical']}")
        return out

    movements12 = {}

    def movement12(name, run, ref):
        """``probe_movement`` of ``run`` on the trained DM, measured once
        per request set and schedule."""
        def measure():
            if name not in movements12:
                movements12[name] = probe_movement(run, exp.dm, dit_err, ref)
            return movements12[name]
        return measure

    def unplaced12(ids, **kw):
        def run(m):
            eng = SynthesisEngine(m, exp.sched, image_size=16,
                                  wave_size=120, ragged=True, **kw)
            rids = submit12(eng, ids)
            out = eng.run(key12)
            return torch.cat([out[r] for r in rids])
        return run

    # 12.1 the 60 uploads, unplaced and over H = 1, 2, 4 hosts
    d12, eng12, wins12 = {}, {}, {}
    for name, kw in (("unplaced_ragged", {}),
                     ("unplaced_compacted", dict(compaction="full")),
                     ("h1_ragged", dict(hosts=1)),
                     ("h2_ragged", dict(hosts=2)),
                     ("h2_ragged_workers_off", dict(hosts=2, workers=False)),
                     ("h2_compacted", dict(hosts=2, compaction="full")),
                     ("h4_ragged", dict(hosts=4)),
                     ("h4_compacted", dict(hosts=4, compaction="full"))):
        eng = engine12(**kw)
        rids = submit12(eng, range(60))
        if "hosts" in kw and "compaction" in kw:
            wins12[name] = (replayed(eng), rids)
        if "hosts" in kw:
            waves = recorded(eng)
            plan_of = (lambda w=waves, c="compaction" in kw: plan12(w, c))
        else:
            it6 = compacted_iters6 if "compaction" in kw else ragged_iters6
            plan_of = (lambda it6=it6: dict(plan11(rowwise=it6),
                                            cfg_update_rowwise_offset=0,
                                            cfg_update_mixed_offset=0))
        out = drain12(name, lambda: eng.run(key12), plan_of)
        d12[name] = torch.cat([out[r] for r in rids])
        eng12[name] = eng
        check(tuple(d12[name].shape) == (n_rows, 16, 16, 3)
              and bool(torch.isfinite(d12[name]).all()),
              f"12.1 {name}: D_syn {tuple(d12[name].shape)}")
        stats = (per_host_sums(eng, name) if "hosts" in kw else
                 {k: eng.stats[k] for k in ("waves", "padded",
                                            "row_iters_scheduled")})
        report12[name] = dict(wall_s=walls12[name],
                              images_per_s=n_rows / walls12[name],
                              stats=stats)
        say(f"[12.1] {name}: {n_rows / walls12[name]:.1f} images/s, wall "
            f"{walls12[name]:.3f} s, {json.dumps(stats)} ({smi})")
    check(torch.equal(d12["h2_ragged"], d12["h2_ragged_workers_off"]),
          "12.1: H = 2 on the hosts' streams differs from workers=False")
    # a compacted window runs other batches than the unplaced wave's (its
    # own activation plan), so it is held bit for bit against its rows
    # sampled again alone by the unplaced compacted sampler with that plan
    replays12 = {}
    for name, (wins, rids) in wins12.items():
        again = replay12(wins, rids, [k_samples] * len(rids))
        replays12[name] = bool(torch.equal(again, d12[name]))
        check(replays12[name], f"12.1 {name}: differs from its windows "
              f"replayed through sample_cfg_compacted, max_abs_err "
              f"{float((again - d12[name]).abs().max()):.3g}")
    say(f"[12.1] compacted placed drains vs their windows replayed alone "
        f"through sample_cfg_compacted with each window's plan: "
        f"bit-identical {replays12}")
    # H = 1 packs the unplaced drain's geometry (15 waves of 120, one
    # window at offset 0): the same kernels at the same shapes
    waves12 = eng12["unplaced_ragged"].stats["waves"]
    same_geom = (eng12["h1_ragged"].stats["waves"] == waves12
                 and eng12["h1_ragged"].stats["padded"]
                 == eng12["unplaced_ragged"].stats["padded"] == 0)
    check(same_geom, "12.1: H = 1 does not pack the unplaced waves")
    check(torch.equal(d12["h1_ragged"], d12["unplaced_ragged"]),
          "12.1: H = 1 differs from the unplaced drain of the same "
          "geometry")
    gates12 = {}
    moves = {m: movement12(m, unplaced12(range(60), **kw), d12["unplaced_"
                                                               + m])
             for m, kw in (("ragged", {}),
                           ("compacted", dict(compaction="full")))}
    for name in ("h2_ragged", "h2_compacted", "h4_ragged", "h4_compacted"):
        mode = name.split("_")[1]
        gates12[name] = gated12(f"12.1 {name} vs the unplaced drain",
                                d12[name], d12["unplaced_" + mode],
                                moves[mode])
    # the same packing change without placement, on the trained DM: the
    # unplaced compacted drain against the unplaced ragged one (phase 6
    # gates it on phase 3's random DiT), printed
    gates12["unplaced_compacted_vs_ragged"] = gated12(
        "12.1 unplaced compacted vs unplaced ragged",
        d12["unplaced_compacted"], d12["unplaced_ragged"], moves["ragged"])
    say(f"[12.1] H = 2 on the hosts' streams vs workers=False: "
        f"bit-identical; H = 1 vs unplaced (the same {waves12} waves, one "
        f"window each): bit-identical")
    report12["gates"] = gates12
    report12["window_replays_bit_identical"] = replays12

    # 12.2 per-host stats (checked above for every placed drain) and a mixed
    # placed drain: 10 uploads and two classifier-guided requests (phase
    # 7's first classifier, 25 steps) over two hosts, 3 waves of 2 x 60,
    # the last mixed: both update kernels launch at row_offset 60
    def tenants12(eng):
        futs = submit12(eng, range(10))
        futs += [eng.submit_classifier_guided(clfs[0], c, k_samples,
                                              guidance=1.0, num_steps=25)
                 for c in (1, 2)]
        return futs

    mixed12 = {}
    for name, kw in (("mixed_unplaced", {}), ("mixed_h2", dict(hosts=2))):
        eng = engine12(**kw)
        rids = tenants12(eng)
        plan_of = None
        if kw:
            waves = recorded(eng)
            plan_of = (lambda w=waves: plan12(w, False))
        out = drain12(name, lambda: eng.run(key12), plan_of)
        mixed12[name] = torch.cat([out[r] for r in rids])
        if kw:
            report12[name] = dict(stats=per_host_sums(eng, name),
                                  per_host=eng.stats["per_host"])
    got = launches12["mixed_h2"]
    check(got["cfg_update_rowwise_offset"] > 0
          and got["cfg_update_mixed_offset"] > 0,
          f"12.2: no launch at a non-zero row_offset: {got}")
    def mixed_run(m):
        eng = SynthesisEngine(m, exp.sched, image_size=16, wave_size=120,
                              ragged=True)
        rids = tenants12(eng)
        out = eng.run(key12)
        return torch.cat([out[r] for r in rids])

    gate_mixed = gated12("12.2 mixed H = 2 vs unplaced", mixed12["mixed_h2"],
                         mixed12["mixed_unplaced"],
                         movement12("mixed", mixed_run,
                                    mixed12["mixed_unplaced"]))
    err_mixed = gate_mixed["max_abs_err"]
    say(f"[12.2] per-host rows, padding and row-iterations sum to the "
        f"global counters in every placed drain; mixed H = 2 drain: "
        f"launches {json.dumps(got)} (plan from its placements), "
        f"rowwise at a non-zero row_offset {got['cfg_update_rowwise_offset']}"
        f", mixed {got['cfg_update_mixed_offset']}; D_syn vs unplaced "
        f"max_abs_err {err_mixed:.3g} (gated row by row); per host "
        f"{json.dumps(report12['mixed_h2']['per_host'])}")

    # 12.3 failover: a window fault kills host 0 at wave 2 of an H = 2
    # drain, twice (bit-identical replays); then every host killed at wave
    # 0 of a 10-upload drain raises AllHostsLostError with the queue
    # intact, and a fresh topology serves it
    fail12 = []
    for i in range(2):
        eng = engine12(hosts=2, faults=FaultInjector([("window", 0, 2)]))
        rids = submit12(eng, range(60))
        waves = recorded(eng)
        out = drain12(f"failover_{i}", lambda: eng.run(key12),
                      lambda w=waves: plan12(w, False))
        check(eng.topology.failed == {0} and len(out) == 60,
              f"12.3: failed {eng.topology.failed}, {len(out)} served")
        fail12.append((torch.cat([out[r] for r in rids]), eng))
    (x_f, eng_f), (x_f2, _) = fail12
    check(torch.equal(x_f, x_f2), "12.3: failover replays differ")
    err_f = gated12("12.3 failover vs the healthy H = 2 drain", x_f,
                    d12["h2_ragged"], moves["ragged"])["max_abs_err"]
    requeued = eng_f.metrics.get("failover.requeued_rows")
    eng = engine12(hosts=2, faults=FaultInjector([("window", 0, 0),
                                                  ("window", 1, 0)]))
    rids = submit12(eng, range(10))
    lost = False
    try:
        eng.run(key12)
    except AllHostsLostError:
        lost = True
    check(lost and [r.rid for r in eng._queue] == rids,
          f"12.3: all hosts lost raised {lost}, queue "
          f"{[r.rid for r in eng._queue]}")
    eng.topology = HostTopology.simulated(2, granule=eng.granule)  # fresh
    out = drain12("all_lost_redrain", lambda: eng.run(key12))
    check(len(out) == 10, f"12.3 re-drain served {len(out)} of 10")
    err_lost = gated12(
        "12.3 re-drain after all hosts lost vs the healthy drain's rows",
        torch.cat([out[r] for r in rids]), d12["h2_ragged"][:10 * k_samples],
        lambda: moves["ragged"]()[:10 * k_samples])["max_abs_err"]
    report12["failover"] = dict(requeued_rows=requeued,
                                failed=sorted(eng_f.topology.failed),
                                max_abs_err_vs_healthy=err_f,
                                redrain_max_abs_err=err_lost)
    say(f"[12.3] host 0 lost at wave 2 of H = 2: failed {{0}}, all 60 "
        f"served, failover.requeued_rows {requeued}, two replays "
        f"bit-identical, vs healthy max_abs_err {err_f:.3g} (gated row by "
        f"row); every host lost: AllHostsLostError, queue "
        f"intact, a fresh topology served all 10 (max_abs_err "
        f"{err_lost:.3g})")

    # 12.4 phase 11.4's stream split across two hosts' host_polls: 10
    # uploads before the drain, then at each wave boundary host 0's hook
    # submits the next 5 and host 1's the 5 after (rids in upload order)
    svc = SynthesisService(engine12(), hosts=2)
    futs12 = {}
    for i, f in zip(range(10), submit12(svc, range(10))):
        futs12[i] = f
    pending12 = list(range(10, 60))

    def hook12():
        for i, f in zip(pending12[:5], submit12(svc, pending12[:5])):
            futs12[i] = f
        del pending12[:5]
        return bool(pending12)

    drain12("h2_streaming", lambda: svc.drain(
        key12, host_polls={0: hook12, 1: hook12}))
    x_s = torch.cat([futs12[i].result() for i in range(60)])
    check(svc.stats["streamed"] == 50,
          f"12.4 streamed {svc.stats['streamed']} of 50")
    err_s = gated12("12.4 host_polls stream vs the H = 2 snapshot", x_s,
                    d12["h2_ragged"], moves["ragged"])["max_abs_err"]
    report12["host_polls"] = dict(max_abs_err=err_s,
                                  bit_identical=bool(torch.equal(
                                      x_s, d12["h2_ragged"])),
                                  stats=per_host_sums(svc.engine, "stream"))
    say(f"[12.4] 50 uploads streamed through two hosts' host_polls vs the "
        f"H = 2 snapshot: max_abs_err {err_s:.3g} (gated row by row), "
        f"bit-identical {report12['host_polls']['bit_identical']}, "
        f"{n_rows / walls12['h2_streaming']:.1f} images/s")

    # 12.5 a topology from a 1 x 1 x 1 serving mesh on the card: its
    # windows on the submesh's device, D_syn the simulated H = 1 drain's
    mesh12 = make_serving_mesh(hosts=1, data=1, model=1)
    eng = engine12(mesh=mesh12, hosts=1)
    sh12 = eng._window_shardings(0)
    check(eng.topology.mesh is mesh12
          and sh12["y"].devices == (torch.device("cuda", 0),),
          f"12.5 window devices {sh12['y'].devices}")
    rids = submit12(eng, range(60))
    out = drain12("h1_mesh", lambda: eng.run(key12))
    x_m = torch.cat([out[r] for r in rids])
    check(x_m.device.type == "cuda" and torch.equal(x_m, d12["h1_ragged"]),
          "12.5: the mesh topology's D_syn differs from simulated H = 1")
    say(f"[12.5] make_serving_mesh(hosts=1, data=1, model=1): windows on "
        f"{sh12['y'].devices}, D_syn bit-identical to the simulated H = 1 "
        f"drain")

    # 12.6 Experiment(hosts=2) on phase 10's checkpoint (copied to a cache
    # directory with no D_syn store): OSCAR once.  Placed waves draw every
    # row from its own key, phase 10's grouped waves from the wave's, so
    # its D_syn is gated against the same requests drained unplaced and
    # ragged from the same key, not against phase 10's
    cache12 = BUILD_DIR / "dm_cache_smoke_hosts"
    shutil.rmtree(cache12, ignore_errors=True)
    cache12.mkdir(parents=True)
    for f in cache10.iterdir():
        if f.name.startswith(exp.tag) and not f.is_dir():
            shutil.copy2(f, cache12 / f.name)
    exp12 = exp_mod.Experiment(ocfg10, verbose=False, cache_dir=cache12,
                               device=dev, hosts=2)
    check(exp12.dm_losses == [] and exp12.engine.topology.num_hosts == 2,
          "12.6: Experiment(hosts=2) did not load the checkpoint")
    kept12 = {}

    def kept_oscar12(*args, **kwargs):
        res = oscar_mod.run_oscar(*args, **kwargs)
        kept12["x"] = res.syn_images
        return res

    exp_mod.run_oscar = kept_oscar12
    waves = recorded(exp12.engine)
    try:
        res12 = drain12("experiment_hosts2_oscar",
                        lambda: exp12.run("oscar", rounds=20),
                        lambda: plan12(waves, False))
    finally:
        exp_mod.run_oscar = oscar_mod.run_oscar
    ksyn12 = prng.split(prng.fold_in(exp12.key, zlib.crc32(b"oscar")), 3)[1]
    enc12, present12 = client_encodings(exp12.fm, exp12.data, device=dev)
    def oscar_run(m):
        return synthesize(ksyn12, m, exp12.sched, enc12, present12,
                          k_samples, image_size=16,
                          engine=SynthesisEngine(m, exp12.sched,
                                                 image_size=16,
                                                 ragged=True))[0]

    x_u = oscar_run(exp12.dm)
    err_e = gated12("12.6 Experiment(hosts=2) OSCAR D_syn vs the unplaced "
                    "ragged drain of its key", kept12["x"], x_u,
                    movement12("oscar", oscar_run, x_u))["max_abs_err"]
    vs10 = max_err(kept12["x"], dsyn10["oscar"])
    report12["experiment_hosts2"] = dict(
        avg_accuracy=res12["avg"],
        table1_avg_accuracy=table1["oscar"]["avg_accuracy"],
        max_abs_err_vs_unplaced_ragged=err_e,
        max_abs_err_vs_phase10_grouped=vs10,
        per_host=exp12.engine.stats["per_host"])
    say(f"[12.6] Experiment(hosts=2) OSCAR: avg accuracy {res12['avg']:.4f} "
        f"(phase 10's {table1['oscar']['avg_accuracy']:.4f}); D_syn vs the "
        f"unplaced ragged drain of the same key max_abs_err {err_e:.3g} "
        f"(gated row by row); vs phase 10's grouped D_syn {vs10:.3g} "
        f"(another sample: grouped waves draw from wave keys)")
    del exp12

    # 12.7 one H = 2 drain traced (20 uploads, 5 waves): two host tracks,
    # and how much of the hosts' device.scan spans overlap (the drain
    # thread fences the windows one after another, so only a span's edges
    # can)
    tracer12 = Tracer()
    eng = engine12(hosts=2, tracer=tracer12)
    submit12(eng, range(20))
    drain12("h2_traced", lambda: eng.run(key12))
    trace12 = write_trace(BUILD_DIR / "placed_trace.json", tracer12,
                          registry=eng.metrics, hosts=2)
    n12 = validate_chrome_trace(trace12, require_hosts=2)
    scans = {h: [(sp.start, sp.end) for sp in tracer12.spans
                 if sp.name == "device.scan" and sp.attrs.get("host") == h]
             for h in (0, 1)}
    both = sum(max(0.0, min(a1, b1) - max(a0, b0))
               for a0, a1 in scans[0] for b0, b1 in scans[1])
    spans0 = sum(b - a for a, b in scans[0]) or 1.0
    report12["trace"] = dict(events=n12, scan_spans={h: len(v) for h, v in
                                                     scans.items()},
                             scan_overlap_s=both,
                             scan_overlap_share_of_host0=both / spans0)
    say(f"[12.7] build/placed_trace.json: {n12} events valid with 2 host "
        f"tracks; the hosts' device.scan spans overlap {both:.4f} s "
        f"({100 * both / spans0:.1f}% of host 0's) ({smi})")

    for name, got in launches12.items():
        for kname in ("adaln_norm", "flash_attention_short",
                      "cfg_update_rowwise_keyed", "cfg_update_mixed_keyed"):
            kernels[kname].setdefault("launches_phase12", {})[name] = \
                got[kname]
    t12 = time.perf_counter() - t12
    say(json.dumps({"placed": dict(report12, launches=launches12,
                                   walls_s=walls12, phase_s=t12,
                                   card=smi)}))
    say(f"[12] placed multi-host drains: {t12:.1f} s ({smi})")
    say(f"[12] the whole script: {time.perf_counter() - t_start:.1f} s")

    say(json.dumps({"kernels": list(kernels.values())}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
