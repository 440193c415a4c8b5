"""Production training launcher: builds the mesh, places the train state
per the partition rules, and runs the train step: the JAX package's
``launch/train.py``.

On the card (the default) or, with ``--device cpu``, on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke --steps 20 --batch 8 --seq 128 [--device cpu]

The mesh is ``make_host_mesh(data, model)`` where it fits the devices
there are, else the production mesh (which refuses on one card, as the
reference's does on a small host).  The step runs on the plain attention
route (``Parallel(use_kernels=False)``: the kernels have no backward), with
the mesh's axes, so an MoE layer takes the expert-parallel ``moe_ep``.
Initial weights are ``init_train_state(PRNGKey(0), cfg)``; batch i is drawn
from ``fold_in(PRNGKey(0), i)`` as the reference draws it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_axes, place, visible_devices)
from repro_torch.models.moe import Parallel
from repro_torch.optim.optimizers import AdamWState
from repro_torch.sharding.rules import batch_specs, param_specs, to_shardings
from repro_torch.train.steps import TrainState, init_train_state, make_train_step
from repro_torch.utils import resolve_device


def draw_batch(cfg: ModelConfig, key, batch: int, seq: int, device) -> dict:
    """The reference launcher's batch for ``key``: tokens ``randint`` over
    the vocabulary; audio frames ``normal``, the mask ``bernoulli(0.3)`` and
    labels ``randint``; vision patches ``normal`` before ``seq - P`` tokens.
    Every draw takes the same key, as the reference's do."""
    if cfg.frontend == "token":
        return {"tokens": prng.randint(key, (batch, seq), 0, cfg.vocab_size,
                                       device)}
    if cfg.frontend == "audio_frames":
        return {"frames": prng.normal(key, (batch, seq, cfg.frontend_dim),
                                      device),
                "mask": prng.bernoulli(key, 0.3, (batch, seq), device),
                "labels": prng.randint(key, (batch, seq), 0, cfg.vocab_size,
                                       device)}
    P = cfg.num_prefix_tokens
    return {"patches": prng.normal(key, (batch, P, cfg.frontend_dim), device),
            "tokens": prng.randint(key, (batch, seq - P), 0, cfg.vocab_size,
                                   device)}


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 8,
          seq: int = 128, data_shards: int = 1, model_shards: int = 1,
          lr: float = 3e-4, device=None, log=print) -> dict:
    """``steps`` AdamW steps of ``cfg`` as the reference's launcher takes
    them, on ``device`` (the card unless the caller passes ``"cpu"``).
    Prints the reference's lines through ``log``.  Returns ``losses`` and
    ``grad_norms`` (one float a step), ``step_s`` (host seconds of each
    step to the end of its device work), ``mesh`` (its shape) and
    ``state``."""
    dev = resolve_device(device)
    fits = data_shards * model_shards <= len(visible_devices(dev))
    mesh = (make_host_mesh(data_shards, model_shards, device=dev) if fits
            else make_production_mesh(device=dev))
    ax = mesh_axes(mesh)
    par = Parallel(model_axis=ax.model, data_axes=ax.data, mesh=mesh,
                   use_kernels=False)
    key = prng.PRNGKey(0)
    state = init_train_state(key, cfg, device=mesh.devices.flat[0])
    psh = to_shardings(param_specs(state.params, ax), mesh)
    place(state.params, psh)
    state = TrainState(state.params, AdamWState(
        state.opt.step, place(state.opt.mu, psh), place(state.opt.nu, psh)))
    shape = InputShape("cli", seq, batch, "train")
    bsh = to_shardings(batch_specs(cfg, shape, ax, batch_sharded=True), mesh)
    step = make_train_step(cfg, par, lr=lr)

    log(f"[launch] {cfg.name} on mesh {mesh.shape}")
    metrics, step_s = [], []
    t0 = time.time()
    for i in range(steps):
        t = time.perf_counter()
        b = place(draw_batch(cfg, prng.fold_in(key, i), batch, seq, dev), bsh)
        state, m = step(state, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
        if i % 10 == 0 or i == steps - 1:
            log(f"  step {i:4d} loss {float(m['loss']):.4f}")
    log(f"[launch] {steps} steps in {time.time() - t0:.1f}s")
    return {"losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "step_s": step_s, "mesh": mesh.shape, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card, or the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 data_shards=args.data_shards,
                 model_shards=args.model_shards, lr=args.lr,
                 device=args.device)


if __name__ == "__main__":
    main()
