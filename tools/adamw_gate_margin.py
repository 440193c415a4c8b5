#!/usr/bin/env python3
"""How far the port's LM train step lies from the JAX reference's after
AdamW, and how large a gradient error explains it, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/adamw_gate_margin.py \
        [--configs hubert-xlarge,internvl2-1b,olmoe-1b-7b,gemma2-2b]

For each config's smoke variant: the reference's ``init_train_state`` from
key 5, three steps of its jitted ``make_train_step`` and of the port's
``make_train_step`` on the same weights and numpy-seeded batches (the
batches ``tests/test_torch_lm_train.py`` uses).  After each step, one JSON
line: the loss and grad norm of both, the largest parameter difference
relative to its leaf's largest element (and which leaf), and the smallest
gradient error, as a share of the step's largest gradient element, that
``optim/optimizers.py::adamw_update_bound`` needs so that every parameter
lies within 1e-5 of its leaf plus the bound.  The tests gate at a share of
1e-5; this prints how much of that margin the port uses.  No card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="hubert-xlarge,internvl2-1b,"
                    "olmoe-1b-7b,gemma2-2b")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    import torch
    from repro.configs import get_config as jget_config
    from repro.configs import shapes as jshapes
    from repro.train.steps import (init_train_state as jinit_train_state,
                                   make_train_step as jmake_train_step)
    from repro_torch.configs import get_config, shapes as tshapes
    from repro_torch.optim.optimizers import AdamWState, adamw_update_bound
    from repro_torch.train.steps import make_train_step
    from test_torch_frontends import as_jax, as_torch, make_batch
    from test_torch_lm_train import LR, as_state, port_state
    torch.set_num_threads(1)
    for name in args.configs.split(","):
        jcfg = jshapes.smoke_config(jget_config(name))
        tcfg = tshapes.smoke_config(get_config(name))
        js = jinit_train_state(jax.random.PRNGKey(5), jcfg)
        jstep = jax.jit(jmake_train_step(jcfg))
        ts = port_state(js.params, tcfg)
        step = make_train_step(tcfg)
        per_unit = None                 # the bound per unit of `rel`, summed
        for i in range(3):
            batch = make_batch(tcfg, 10 + i, S=24)
            before = AdamWState(i, as_state(js.opt.mu, tcfg), None)
            js, jm = jstep(js, as_jax(batch))
            ts, tm = step(ts, as_torch(batch))
            unit = adamw_update_bound(
                before, AdamWState(i + 1, as_state(js.opt.mu, tcfg),
                                   as_state(js.opt.nu, tcfg)), lr=LR,
                rel=1.0)
            per_unit = unit if per_unit is None else {
                k: per_unit[k] + v for k, v in unit.items()}
            want, got = as_state(js.params, tcfg), ts.params.state_dict()
            rel = {k: float((got[k] - w).abs().max() / w.abs().max())
                   for k, w in want.items()}
            need = max(float((((got[k] - w).abs() - 1e-5 * w.abs().max())
                              .clamp(min=0) / per_unit[k]).max())
                       for k, w in want.items())
            worst = max(rel, key=rel.get)
            print(json.dumps({
                "config": tcfg.name, "step": i + 1,
                "loss": [float(jm["loss"]), float(tm["loss"])],
                "grad_norm": [float(jm["grad_norm"]),
                              float(tm["grad_norm"])],
                "params_max_rel_err": rel[worst], "leaf": worst,
                "gradient_error_share_needed": need}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
