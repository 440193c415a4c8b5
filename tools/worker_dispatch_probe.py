#!/usr/bin/env python3
"""Where a placed drain's window launches belong: on one thread per host
(the JAX package's layout, where each host's worker dispatches its
window's jitted chain) or on the drain thread, each window on its host's
CUDA stream (the port's ``SynthesisEngine``).

    python3 tools/worker_dispatch_probe.py [--rounds 2]

Needs one CUDA card.  Phase 3's DiT width (``init_dit`` from key 1 at the
paper preset, perturbed 0.05·normal), 60 random encodings at phase 6's
four (guidance, steps), 30 rows each, ragged waves of 120 over H = 2 and
4 simulated hosts: ``workers=False`` (every window on the drain thread's
stream), ``workers=True`` (the engine: every window on its host's stream,
launched from the drain thread), and the engine with every window
launched from a thread of its host's own, on its host's stream.  Prints
each drain's wall (host clock to ``torch.cuda.synchronize()``), checks
the three give the same bits, and ends with one JSON line and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("worker_dispatch_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.configs.oscar import DiffusionConfig
    from repro_torch.diffusion.dit import init_dit
    from repro_torch.diffusion.schedule import make_schedule
    from repro_torch.serve import SynthesisEngine
    from repro_torch.utils import default_device

    class ThreadLaunches(SynthesisEngine):
        """The engine with each window launched from a thread of its
        host's own (the JAX package's workers), every window before any
        fence."""

        def _sample_wave_placed(self, parts_h, placement, key, max_steps,
                                wave=-1):
            wins = placement.windows
            packed = [self._pack_window(w, parts_h[w.host], max_steps,
                                        placement.total_rows, wave, False)
                      for w in wins]
            ctx = self._wave_ctx(np.concatenate([p[0] for p in packed]),
                                 [m for p in packed for m in p[1]], key,
                                 max_steps, False, placement.total_rows)
            if not hasattr(self, "_threads"):
                self._threads = {}
            futs = []
            for w, p in zip(wins, packed):
                if w.host not in self._threads:
                    self._threads[w.host] = ThreadPoolExecutor(
                        1, initializer=torch.cuda.set_device,
                        initargs=(self.device,))
                futs.append(self._threads[w.host].submit(
                    self._dispatch_window, w, p[3], ctx, wave))
            xs = [f.result() for f in futs]
            return xs, [p[2] for p in packed], [p[4] for p in packed]

    dev = default_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dc = DiffusionConfig(d_model=144, num_layers=4, num_heads=4)
    model = init_dit(prng.PRNGKey(1), dc, 16, 3, device=dev)
    g = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    model.eval()
    sched = make_schedule(device=dev)
    enc = np.random.default_rng(0).standard_normal((60, 512))
    enc = (enc / np.linalg.norm(enc, axis=1, keepdims=True)).astype(
        np.float32)
    combos = [(1.5, 50), (4.0, 50), (7.5, 25), (1.5, 25)]
    key = prng.PRNGKey(12)

    def drain(cls, hosts, workers):
        eng = cls(model, sched, image_size=16, wave_size=120, ragged=True,
                  hosts=hosts, workers=workers)
        rids = [eng.submit(enc[i], i % 10, 30, guidance=combos[i % 4][0],
                           num_steps=combos[i % 4][1]) for i in range(60)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for ex in getattr(eng, "_threads", {}).values():
            ex.shutdown()
        return torch.cat([out[r] for r in rids]), wall

    variants = {"workers_off": (SynthesisEngine, False),
                "host_streams": (SynthesisEngine, True),
                "host_thread_launches": (ThreadLaunches, True)}
    walls = {}
    for rnd in range(args.rounds):
        for hosts in (2, 4):
            first = None
            for name, (cls, workers) in variants.items():
                x, wall = drain(cls, hosts, workers)
                first = x if first is None else first
                if not torch.equal(x, first):
                    raise RuntimeError(f"{name} at H = {hosts} differs")
                walls.setdefault(f"h{hosts}_{name}", []).append(wall)
                print(f"round {rnd} H = {hosts} {name}: {wall:.3f} s, "
                      f"{1800 / wall:.1f} images/s", flush=True)
    print(json.dumps({"worker_dispatch_walls_s": walls, "card": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
