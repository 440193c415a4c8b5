"""OSCAR — One-Shot federated learning with ClAssifier-fRee diffusion
models (the paper's §IV pipeline, end to end):

  (1) each client encodes its images with the frozen FM (Eq. 6) and
      mean-pools per category (Eq. 7)                     [client side]
  (2) each client uploads its C × 512 category encodings  [ONE round]
  (3) the server runs classifier-free guided sampling (Eq. 8/9) to
      synthesise ``k_samples`` images per uploaded (client, category)
      encoding → D_syn
  (4) the server trains the global classifier on D_syn and broadcasts it
      (``run_oscar``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.oscar import OscarConfig
from repro_torch.core.classifier_train import (evaluate_per_domain,
                                               fit_global)
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.encoders.foundation import FrozenFM, category_encodings
from repro_torch.models.classifiers import init_classifier
from repro_torch.serve.service import SynthesisService
from repro_torch.serve.synthesis import SynthesisEngine
from repro_torch.utils import resolve_device


@dataclass
class OscarResult:
    metrics: dict                 # avg + per-client test accuracy (Table I row)
    upload_per_client: int        # parameters uploaded by each client
    syn_images: torch.Tensor      # D_syn (N, H, W, C), on the DiT's device
    syn_labels: torch.Tensor      # (N,) int64
    encodings: np.ndarray         # (R, C, 512) what was uploaded
    global_params: torch.nn.Module | None = None


@torch.inference_mode()
def client_encodings(fm: FrozenFM, data, *, device=None):
    """Steps (1)+(2): per-client per-category mean encodings, computed on
    ``device`` (the card unless the caller passes ``"cpu"``).  Returns the
    upload as host arrays: enc (R, C, dim) float32, present (R, C) bool."""
    device = resolve_device(device)
    R = data.client_images.shape[0]
    C = data.num_categories
    enc = np.zeros((R, C, fm.dim), np.float32)
    present = np.zeros((R, C), bool)
    for r in range(R):
        m, p = category_encodings(
            fm, torch.as_tensor(data.client_images[r], device=device),
            data.client_labels[r], C)
        enc[r] = m.cpu().numpy()
        present[r] = p.cpu().numpy()
    return enc, present


def synthesize(key, model: DiT, sched: NoiseSchedule, encodings, present,
               k_samples: int, *, image_size: int, channels: int = 3,
               guidance: float | None = None, num_steps: int | None = None,
               wave_size: int = 128, ragged: bool = False,
               compaction: int | str | None = None,
               engine: SynthesisEngine | None = None,
               service: SynthesisService | None = None, topology=None,
               hosts: int | None = None, tracer=None):
    """Step (3): server-side D_syn generation on the model's device, from
    the threefry ``key``.

    Every present (client, category) encoding becomes one request of
    ``k_samples`` rows, in (client, category) order, submitted to a
    ``SynthesisService`` and gathered with ``key`` as its drain key: a
    caller's ``engine`` (over the same model) beats a shared ``service``
    (callers pass an engine to keep its cache apart), a shared service
    serves repeats from its row cache and store, else a new engine of
    near-uniform waves of at most ``wave_size`` rows.  ``ragged``,
    ``compaction``, ``topology``/``hosts`` (placed drains) and ``tracer``
    switch the chosen engine on, never off (``SynthesisEngine.opt_in``).
    Returns
    (images (N, H, W, C) float32, labels (N,) int64), both on the model's
    device; an all-absent ``present`` gives empty tensors."""
    device = model.null_y.device
    svc, eng = service, engine
    if eng is not None:
        svc = None        # an explicit engine beats a shared service
    elif svc is not None:
        eng = svc.engine
    if eng is None:
        eng = SynthesisEngine(model, sched, image_size=image_size,
                              channels=channels, wave_size=wave_size,
                              ragged=ragged, compaction=compaction,
                              topology=topology, hosts=hosts, tracer=tracer)
    else:
        eng.opt_in(ragged=ragged, compaction=compaction, topology=topology,
                   hosts=hosts, tracer=tracer)
    if svc is None:
        svc = SynthesisService(eng)
    R, C, _ = encodings.shape
    futs, cats = [], []
    for r in range(R):
        for c in range(C):
            if present[r, c]:
                futs.append(svc.submit(encodings[r, c], c, k_samples,
                                       guidance=guidance,
                                       num_steps=num_steps))
                cats.append(c)
    if not futs:
        return (torch.zeros((0, image_size, image_size, channels),
                            device=device),
                torch.zeros((0,), dtype=torch.int64, device=device))
    images = torch.cat(svc.gather(futs, key))
    labels = np.repeat(np.asarray(cats, np.int64), k_samples)
    return images, torch.as_tensor(labels, device=device)


def run_oscar(key, ocfg: OscarConfig, data, model: DiT, sched: NoiseSchedule,
              fm: FrozenFM, *, classifier: str | None = None,
              samples_per_category: int | None = None,
              classifier_steps: int | None = None,
              guidance: float | None = None,
              engine: SynthesisEngine | None = None,
              service: SynthesisService | None = None, ragged: bool = False,
              compaction: int | str | None = None, topology=None,
              hosts: int | None = None, tracer=None) -> OscarResult:
    """The whole pipeline from the threefry ``key``, on the DiT's device:
    ``kenc, ksyn, kclf = split(key, 3)``; client encodings, D_syn from
    ``ksyn``, the global classifier initialised and trained from ``kclf``
    (``fit_global``), and its per-domain test accuracy.  With no D_syn
    (nothing present) the broadcast model is the untrained init.  D_syn
    goes through ``synthesize``'s engine or service (see there), placed
    over ``topology``/``hosts`` when given.

    The reference's ``use_pallas`` is not ported: CUDA tensors always take
    the kernels."""
    classifier = classifier or ocfg.classifier
    k_samples = samples_per_category or ocfg.samples_per_category
    # the first key is the reference's kenc, which nothing draws from
    _, ksyn, kclf = prng.split(np.asarray(key, np.uint32), 3)
    device = model.null_y.device
    C = data.num_categories

    enc, present = client_encodings(fm, data, device=device)
    syn_x, syn_y = synthesize(ksyn, model, sched, enc, present, k_samples,
                              image_size=ocfg.data.image_size,
                              channels=ocfg.data.channels, guidance=guidance,
                              engine=engine, service=service, ragged=ragged,
                              compaction=compaction, topology=topology,
                              hosts=hosts, tracer=tracer)
    if len(syn_x) == 0:
        # degenerate round: no (client, category) present anywhere, so no
        # D_syn, and the broadcast model is the untrained init
        gp = init_classifier(kclf, classifier, C, device=device)
    else:
        gp = fit_global(kclf, classifier, C, syn_x, syn_y,
                        steps=classifier_steps or ocfg.classifier_steps,
                        batch=ocfg.classifier_batch, device=device)
    metrics = evaluate_per_domain(gp, classifier, data)
    upload = C * ocfg.encoding_dim          # C × 512 (Table IV)
    return OscarResult(metrics, upload, syn_x, syn_y, enc, gp)
