"""Production-mesh dry run: every (arch × input shape) step on the meta
device, at full size, with nothing allocated: the JAX package's
``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per pair it builds ``LM(cfg, device="meta")`` (allocated, not drawn) on
``make_production_mesh(device="meta")`` (16 × 16, or 2 × 16 × 16 over two
pods), serving leaves cast to the activation dtype, and runs the train,
prefill or decode step on the plain route (no kernel runs on meta) under
``hlo_analysis.count_step``.  It records the per-device argument bytes
under the partition rules (``_sharded_bytes``, the reference's reckoning),
the step's FLOPs and bytes (global, and per device as global / n_devices:
that assumes the step partitions evenly over the mesh), the three roofline
terms on an H100, and the reference's record keys.  Where the reference
lowers and compiles, the port counts: ``t_lower_s`` is the time to build
the meta model and its specs, ``t_compile_s`` the time of the counted
step.  There is no compiled program, so ``memory`` holds the analytic
argument bytes and says so.

Results merge into a JSON file under ``build/`` (``--out``).  Unlike the
reference, importing this module sets nothing: the meta mesh needs no
device count.  A pair costs seconds on a CPU (olmoe-1b-7b × train_4k ~7 s
of counting), except where the port loops in Python over positions where
the reference scans: xlstm-125m's sLSTM and jamba's Mamba scan, whose
train_4k and prefill_32k pairs take 2.5–6.5 min each (``--all``, 40 pairs,
~19 min).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, input_specs
from repro_torch.configs.shapes import resolve_decode_config, shape_supported
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import (NamedSharding, make_production_mesh,
                                     mesh_axes)
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizers import AdamWState, init_adamw
from repro_torch.serve.steps import make_prefill_step
from repro_torch.sharding.rules import cache_specs, is_spec, param_specs
from repro_torch.train.steps import TrainState, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build"


def _pairs(tree, specs):
    """(tensor, spec) for every tensor leaf of ``tree`` (dicts, lists,
    NamedTuples) and its spec in the same-shaped ``specs``."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)) and not is_spec(specs):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def _sharded_bytes(tree, spec_tree, mesh) -> float:
    """Per-device bytes of a tree under the given specs (analytic): each
    leaf's bytes over the devices its spec splits it across."""
    total = 0.0
    for t, spec in _pairs(tree, spec_tree):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for n in names:
                shards *= mesh.shape[n]
        total += math.prod(t.shape) * t.element_size() / shards
    return total


@dataclass
class Pair:
    """One (arch × shape × mesh) pair set up for counting: its config and
    mesh, the step and its arguments (meta tensors), and the per-device
    argument bytes under the partition rules."""
    cfg: object
    shape: object
    mesh: object
    batch_sharded: bool
    step: object
    args: tuple
    arg_bytes: float
    note: str


def setup(arch: str, shape_name: str, *, multi_pod: bool = False,
          overrides: dict | None = None):
    """Everything of a pair but the count: a ``Pair``, or the skip record
    of a pair the reference skips."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    ok, note = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip", "note": note}
    cfg = resolve_decode_config(cfg, shape)
    overrides = overrides or {}
    if overrides.get("use_pallas") or overrides.get("use_kernels"):
        raise ValueError("no kernel runs on the meta device: the dry run "
                         "takes the plain route")
    par_kw = {k: v for k, v in overrides.items()
              if k in ("moe_combine", "attn_impl", "prefill_last_only",
                       "gqa_repeat", "decode_cache")}
    cfg_kw = {k: v for k, v in overrides.items() if k in ("remat", "dtype")}
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    ax = mesh_axes(mesh)
    data_shards = math.prod(mesh.shape[a] for a in ax.data)
    batch_sharded = shape.global_batch % data_shards == 0
    bdim = ax.all_data if batch_sharded else None
    par = Parallel(model_axis="model", data_axes=ax.data, mesh=mesh,
                   use_kernels=False, batch_sharded=batch_sharded,
                   logits_spec=NamedSharding(mesh, (bdim, None, "model")),
                   **par_kw)
    if overrides.get("seq_parallel"):
        par = Parallel(**{**par.__dict__, "resid_spec": NamedSharding(
            mesh, (bdim, "model", None))})
    if overrides.get("shard_heads"):
        # q on (padded) head sharding over model; kv replicated on model
        par = Parallel(**{**par.__dict__, "qkv_spec": (
            NamedSharding(mesh, (bdim, None, "model", None)),
            NamedSharding(mesh, (bdim, None, None, None)))})

    specs = input_specs(cfg, shape)
    # training holds fp32 masters; serving runs on weights in the activation
    # dtype (the LM keeps its few uncast leaves, norm scales among them, in
    # fp32), reckoned all cast, as the reference casts every float leaf
    lm = LM(cfg, device="meta",
            param_dtype=torch.float32 if shape.kind == "train" else None)
    params = {k: v.detach() if shape.kind == "train" else
              v.detach().to(cfg.act_dtype) for k, v in lm.named_parameters()}
    p_mode = "train"
    if shape.kind != "train":
        if overrides.get("serve2d"):
            p_mode = "serve2d"
        elif overrides.get("serve1d"):
            p_mode = "serve1d"
    pspecs = param_specs(lm, ax, mode=p_mode)
    arg_bytes = _sharded_bytes(params, pspecs, mesh)

    if shape.kind == "train":
        opt = init_adamw(params)
        count = torch.empty((), dtype=torch.int32, device="meta")
        # the reference's state: params, AdamW's count and two moments
        arg_bytes += _sharded_bytes(
            {"count": count, "mu": opt.mu, "nu": opt.nu},
            {"count": (), "mu": pspecs, "nu": pspecs}, mesh)
        state = TrainState(lm, AdamWState(0, opt.mu, opt.nu))
        step, args = make_train_step(cfg, par), (state, specs["batch"])
    elif shape.kind == "prefill":
        step, args = make_prefill_step(lm, par), (specs["batch"],)
    else:  # decode
        caches = specs["caches"]
        c_specs = cache_specs(cfg, shape, ax, batch_sharded, caches)
        arg_bytes += _sharded_bytes(caches, c_specs, mesh)

        def step(tokens, caches):
            with torch.inference_mode():
                return lm.decode_step(tokens, caches, shape.seq_len - 1, par)
        args = (specs["tokens"], caches)
    return Pair(cfg, shape, mesh, batch_sharded, step, args, arg_bytes, note)


def build(arch: str, shape_name: str, *, multi_pod: bool = False,
          overrides: dict | None = None) -> dict:
    """Count one (arch × shape × mesh) step on meta.  Returns the record."""
    overrides = overrides or {}
    t0 = time.time()
    pair = setup(arch, shape_name, multi_pod=multi_pod, overrides=overrides)
    if isinstance(pair, dict):
        return pair
    t_lower = time.time() - t0

    t0 = time.time()
    cost = hlo.count_step(pair.step, *pair.args)
    t_compile = time.time() - t0

    cfg, shape, mesh = pair.cfg, pair.shape, pair.mesh
    n_dev = mesh.size
    mem = {"error": "no compiled program on the port: the argument bytes "
                    "are analytic",
           "arg_bytes_analytic_per_device": pair.arg_bytes}
    flops, bytes_accessed = cost.flops / n_dev, cost.bytes / n_dev
    terms = hlo.roofline_terms(flops, bytes_accessed, cost.collective_bytes)
    pc = cfg.param_counts()
    # MODEL_FLOPS: 6·N·D for training, 2·N·D forward-only (decode/prefill)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf_factor = 6 if shape.kind == "train" else 2
    model_flops = mf_factor * pc["active"] * tokens
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "note": pair.note,
        "mesh": dict(mesh.shape),
        "n_devices": n_dev,
        "batch_sharded": pair.batch_sharded,
        "overrides": overrides,
        "t_lower_s": round(t_lower, 2), "t_compile_s": round(t_compile, 2),
        "params_total": pc["total"], "params_active": pc["active"],
        "flops_per_device": flops, "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": cost.collective_bytes / n_dev,
        "collectives": {k: {"bytes": v, "count": cost.coll_count_by_kind[k]}
                        for k, v in cost.coll_bytes_by_kind.items()},
        "collectives_note": cost.note,
        "ops": cost.ops,
        "roofline": terms,
        "bottleneck": hlo.dominant_term(terms),
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / cost.flops) if cost.flops
        else None,
        "memory": mem,
    }


def merge_result(result: dict, out_path: Path):
    out_path.parent.mkdir(parents=True, exist_ok=True)
    data = {}
    if out_path.exists():
        data = json.loads(out_path.read_text())
    key = "|".join([result["arch"], result["shape"],
                    "2pod" if result["multi_pod"] else "1pod",
                    json.dumps(result.get("overrides") or {}, sort_keys=True)])
    data[key] = result
    out_path.write_text(json.dumps(data, indent=1, sort_keys=True))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR / "dryrun.json"))
    ap.add_argument("--override", action="append", default=[],
                    help="k=v (remat, dtype, moe_combine, seq_parallel)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(v.lower(), v)

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    out_path = Path(args.out)
    for arch, shape in pairs:
        print(f"=== dry-run {arch} × {shape} "
              f"({'2-pod 512' if args.multi_pod else '1-pod 256'} devices, "
              f"meta) ===", flush=True)
        try:
            res = build(arch, shape, multi_pod=args.multi_pod,
                        overrides=overrides)
        except Exception:
            res = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                   "status": "error", "error": traceback.format_exc(),
                   "overrides": overrides}
        merge_result(res, out_path)
        if res["status"] == "ok":
            t = res["roofline"]
            print(f"  build {res['t_lower_s']}s count {res['t_compile_s']}s"
                  f" | flops/dev {res['flops_per_device']:.3e} "
                  f"bytes/dev {res['bytes_per_device']:.3e} "
                  f"coll/dev {res['collective_bytes_per_device']:.3e}")
            print(f"  roofline: compute {t['t_compute']*1e3:.2f}ms "
                  f"memory {t['t_memory']*1e3:.2f}ms "
                  f"collective {t['t_collective']*1e3:.2f}ms "
                  f"-> {res['bottleneck']}-bound | useful-flops "
                  f"{(res['useful_flops_ratio'] or 0):.2f}")
            print(f"  memory: {res['memory']}")
        else:
            print(f"  {res['status'].upper()}: "
                  f"{res.get('note') or res.get('error', '')[-2000:]}")


if __name__ == "__main__":
    main()
