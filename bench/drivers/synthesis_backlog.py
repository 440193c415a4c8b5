"""A backlog of D_syn upload requests through the program's front door:
``SynthesisService.submit`` and one streaming ``drain`` over
``SynthesisEngine.run``.

The service starts with ``queued_waves`` waves of requests queued; at every
wave boundary the drain's ``poll`` submits one wave's worth more, so the
queue never runs dry and every wave is full.  Waves are whole requests
(``wave_images`` a multiple of ``images_per_request``), so a boundary
delivers whole requests.  The first ``warm_waves`` boundaries are set-up
(the first wave builds and loads every kernel); the window opens at the
next boundary and closes at the first boundary after ``seconds``, where
``poll`` ends the drain.

The check samples ``check_requests`` of the requests delivered inside the
window and runs the plain reference on each from the inputs alone: the
drain key, the wave the request's rows went into under first-in first-out
packing (request i is in wave i // requests-a-wave, at rows
(i mod requests-a-wave) · images on), its encoding, guidance and steps.
"""
from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from bench import traffic as traffic_mod
from bench import weights
from bench.references import threefry


class _WindowClosed(BaseException):
    """Raised by ``poll`` at the boundary that closes the window.  Not an
    ``Exception``: the service turns those into failed requests and drains
    on; this one ends the drain, leaving the unserved requests queued."""


def _key(seed: int, tag: int) -> np.ndarray:
    return np.random.SeedSequence([int(seed), tag]).generate_state(
        2, np.uint32)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.spec, self.seed = config, traffic, seed
        self.device = device
        self.ref = importlib.import_module(
            f"bench.references.{config['reference']}")
        per, rem = divmod(traffic["wave_images"],
                          traffic["images_per_request"])
        if rem:
            raise ValueError("wave_images must hold whole requests")
        self.per_wave = per
        self.drain_key = _key(seed, 6)
        self.futures: list = []
        self.done_at: dict[int, int] = {}    # request -> boundary delivered
        self.boundary = 0
        self.begin_b = self.end_b = None
        self.stats: dict = {}
        self.marks: list[float] = []         # host clock at each boundary

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from repro_torch.configs.oscar import DiffusionConfig
        from repro_torch.diffusion.dit import DiT
        from repro_torch.diffusion.schedule import make_schedule
        from repro_torch.serve import SynthesisEngine, SynthesisService

        c = self.cfg
        dc = DiffusionConfig(
            d_model=c["d_model"], num_layers=c["num_layers"],
            num_heads=c["num_heads"], patch=c["patch"],
            cond_dim=c["cond_dim"], train_timesteps=c["train_timesteps"],
            sample_timesteps=c["sample_timesteps"],
            guidance_scale=c["guidance_scale"], schedule=c["schedule"])
        model = DiT(dc, c["image_size"], c["channels"], device=self.device)
        weights.fill_module(model, self.ref.weight_groups(c), self.seed)
        model.eval()
        sched = make_schedule(c["train_timesteps"], c["schedule"],
                              device=self.device)
        engine = SynthesisEngine(
            model, sched, image_size=c["image_size"], channels=c["channels"],
            wave_size=self.spec["wave_images"])
        if engine.wave_size != self.spec["wave_images"]:
            raise ValueError(f"the engine rounds waves to {engine.wave_size}"
                             f" rows, not {self.spec['wave_images']}")
        self.service = SynthesisService(engine)

    # -- the window ---------------------------------------------------------
    def _submit_wave(self):
        for _ in range(self.per_wave):
            u = traffic_mod.upload(self.spec, self.seed, len(self.futures),
                                   self.cfg["cond_dim"])
            self.futures.append(self.service.submit(
                u.encoding, u.category, u.count, guidance=u.guidance,
                num_steps=u.steps))

    def _mark_done(self):
        for i, f in enumerate(self.futures):
            if i not in self.done_at and f.done():
                self.done_at[i] = self.boundary

    def run_window(self, seconds: float, window) -> None:
        for _ in range(self.spec["queued_waves"]):
            self._submit_wave()
        eng = self.service.engine

        def poll():
            self.boundary += 1
            self.marks.append(time.perf_counter())
            self._mark_done()
            if window.start is None and \
                    self.boundary > self.spec["warm_waves"]:
                window.begin()
                self.begin_b, self.stats["begin"] = self.boundary, eng.stats
            elif window.over(seconds):
                window.end()
                self.end_b, self.stats["end"] = self.boundary, eng.stats
                raise _WindowClosed
            self._submit_wave()
            return True

        try:
            self.service.drain(self.drain_key, poll=poll)
        except _WindowClosed:
            pass
        else:
            raise RuntimeError("the drain ended before the window closed")
        gaps = np.diff(self.marks[self.begin_b - 1:self.end_b])
        print("[bench] waves of the window (s): "
              + " ".join(f"{g:.4f}" for g in gaps), file=sys.stderr)

    def _in_window(self) -> list[int]:
        return sorted(i for i, b in self.done_at.items()
                      if self.begin_b < b <= self.end_b)

    def facts(self) -> dict:
        """What the readers read: images delivered and waves inside the
        window, and the engine's counters at its two ends."""
        imgs = sum(self.futures[i].result().shape[0]
                   for i in self._in_window()
                   if self.futures[i].exception() is None)
        return {"images": imgs, "waves": self.end_b - self.begin_b,
                "stats": self.stats}

    def attempted_failed(self) -> tuple[int, int]:
        inside = self._in_window()
        return len(inside), sum(self.futures[i].exception() is not None
                                for i in inside)

    # -- the check ----------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        """The compared numbers over a sample of the window's requests:
        ``image_max_abs``, the largest |program − reference| of any pixel,
        and ``image_rms_max``, the largest root-mean-square difference of
        one image.  With ``control`` also the same numbers for the
        reference computed with TF32 products in the program's place:
        {"program": ..., "control": ...}."""
        inside = self._in_window()
        k = min(self.spec["check_requests"], len(inside))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 5]))
        sample = sorted(rng.choice(inside, k, replace=False).tolist())
        got = {i: self.futures[i].result() for i in sample}
        # the program's state goes before the reference runs
        del self.service
        self.futures = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        w = weights.draw_group(self.ref.weight_groups(self.cfg)[0],
                               self.seed, 0, self.device)
        modes = {"program": got}
        refs = {}
        prev = torch.backends.cuda.matmul.allow_tf32
        try:
            for tf32 in ([False, True] if control else [False]):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                out = {}
                for i in sample:
                    out[i] = self._reference(w, i)
                if tf32:
                    modes["control"] = out
                else:
                    refs = out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        nums = {m: self._numbers(rows, refs) for m, rows in modes.items()}
        return nums if control else nums["program"]

    def _reference(self, w, i: int) -> torch.Tensor:
        u = traffic_mod.upload(self.spec, self.seed, i, self.cfg["cond_dim"])
        wave, j = divmod(i, self.per_wave)
        return self.ref.sample_rows(
            w, self.cfg, threefry.fold_in(self.drain_key, wave),
            j * u.count, np.repeat(u.encoding[None], u.count, 0),
            u.guidance, u.steps, self.device)

    @staticmethod
    def _numbers(rows: dict, refs: dict) -> dict:
        mx, rms = 0.0, 0.0
        for i, r in refs.items():
            d = (rows[i].float() - r).reshape(r.shape[0], -1)
            mx = max(mx, float(d.abs().max()))
            rms = max(rms, float(d.pow(2).mean(1).sqrt().max()))
        return {"image_max_abs": mx, "image_rms_max": rms}
