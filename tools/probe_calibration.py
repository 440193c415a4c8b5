#!/usr/bin/env python3
"""Readings for the 4-step kernel-vs-plain gates of ``chip_smoke.py``
(phases 4 and 6): for many rows, how far the kernel path's 4-step wave lies
from the plain DiT's and how far ``chip_smoke.probe_movement`` (every DiT
output moved by ± the DiT's kernel-vs-plain difference, both signs) moves
the plain wave.
Their ratio is what ``K_PROBE`` must cover.

    python3 tools/probe_calibration.py [--waves 256] [--out PATH]

Needs one CUDA card.  Runs phase 3's DiT (``init_dit`` from key 1 at the
paper preset's width, perturbed 0.05·normal) on the paper preset's client
encodings: ``sample_cfg`` waves of 8 rows at 4 steps (phase 4) and
``sample_cfg_ragged`` waves of 8 rows at phase 6's four (guidance, steps),
each wave from its own draws.  Prints a summary as one JSON line and
writes every row's reading to ``--out`` (default
``chiprun_out/probe_calibration.json``).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=256)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "probe_calibration.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_calibration: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.configs.oscar import DataConfig, DiffusionConfig
    from repro_torch.core.oscar import client_encodings
    from repro_torch.data.federated import make_federated_data
    from repro_torch.diffusion.dit import init_dit
    from repro_torch.diffusion.sampler import sample_cfg, sample_cfg_ragged
    from repro_torch.diffusion.schedule import make_schedule
    from repro_torch.encoders.foundation import FrozenFM

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(3)
    dc = DiffusionConfig(d_model=144, num_layers=4, num_heads=4, patch=4,
                         cond_dim=512)
    model = init_dit(prng.PRNGKey(1), dc, 16, 3, device=dev)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    model.eval()
    plain = copy.deepcopy(model)
    plain.plain = True
    sched = make_schedule(1000, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # the probe's amplitude as phase 3 measures it
    xt, yy = randn(256, 16, 16, 3), randn(256, 512)
    tt = torch.randint(0, 1000, (256,), generator=g, device=dev)
    with torch.inference_mode():
        amp = max(cs.max_err(model(xt, tt, y), plain(xt, tt, y))
                  for y in (yy, None))
    data = make_federated_data(DataConfig(**cs.PAPER_DATA))
    enc, present = client_encodings(FrozenFM(), data, device=dev)
    enc = torch.as_tensor(enc[present], device=dev)

    combos4 = [(1.5, 4), (4.0, 4), (7.5, 2), (1.5, 2)]
    g4 = np.repeat([c[0] for c in combos4], 2).astype(np.float32)
    s4 = np.repeat([c[1] for c in combos4], 2)
    rows = []
    with torch.inference_mode():
        for w in range(args.waves):
            y = enc[(np.arange(8) + 8 * w) % len(enc)]
            x_T, noise = randn(8, 16, 16, 3), randn(4, 8, 16, 16, 3)
            keys = prng.fold_in(prng.PRNGKey(1000 + w)[None], np.arange(8))
            runs = {
                "sample_cfg": lambda m: sample_cfg(
                    m, sched, y, num_steps=4, x_T=x_T, noise=noise),
                "sample_cfg_ragged": lambda m: sample_cfg_ragged(
                    m, sched, y, keys, g4, s4)}
            for sampler, run in runs.items():
                ref = run(plain)
                err = (run(model) - ref).abs().flatten(1).amax(1)
                moved = cs.probe_movement(run, plain, amp, ref)
                rows += [dict(sampler=sampler, wave=w, row=i,
                              err=float(err[i]), probe=float(moved[i]))
                         for i in range(8)]
    ill = [r for r in rows if max(r["err"], r["probe"]) > cs.TOL_E2E]
    ratios = sorted(r["err"] / max(r["probe"], 1e-30) for r in ill)
    summary = dict(
        rows=len(rows), probe_amplitude=amp, tol=cs.TOL_E2E,
        k_probe=cs.K_PROBE,
        rows_over_tol=len(ill),
        waves_with_a_row_over_tol={s: len({r["wave"] for r in ill
                                           if r["sampler"] == s})
                                   for s in runs},
        waves_per_sampler=args.waves,
        max_err_rows_under_tol=max(r["err"] for r in rows if r not in ill),
        ratio_err_over_probe=dict(
            max=max(ratios, default=None),
            median=ratios[len(ratios) // 2] if ratios else None,
            min=min(ratios, default=None)),
        over_gate=sum(r["err"] > max(cs.TOL_E2E, cs.K_PROBE * r["probe"])
                      for r in rows),
        ill_rows=[(r["sampler"], r["wave"], r["row"], r["err"], r["probe"])
                  for r in ill])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(summary=summary, rows=rows), indent=1))
    print(json.dumps({"probe_calibration": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
