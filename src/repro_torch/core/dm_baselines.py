"""DM-assisted OSFL baselines the paper compares against.

FedCADO (Yang et al. 2023): every client trains a FULL classifier on its
local data and uploads it.  The server runs CLASSIFIER-GUIDED sampling
(Eq. 4), a gradient through the client classifier at every denoising
step, to synthesise per-category data, then trains the global model.

FedDISC (Yang et al. 2024): clients upload per-category feature
statistics (means + spreads + a few prototype features) of a frozen
encoder; the server re-samples encodings from those statistics and
generates via the (classifier-free) DM.  Upload ≈ 6 × C × 512.

Both run on the DiT's device and draw D_syn through a
``SynthesisService`` (``_service``), submitting futures and gathering
them with the method's own key; ``topology``/``hosts`` place its drains
over hosts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.oscar import OscarConfig
from repro_torch.core.classifier_train import (evaluate_per_domain,
                                               fit_global, train_classifier)
from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.encoders.foundation import FrozenFM
from repro_torch.models.classifiers import (classifier_logprob,
                                            classifier_param_count,
                                            init_classifier)
from repro_torch.serve.service import SynthesisService
from repro_torch.serve.synthesis import SynthesisEngine


def _service(service, engine, ocfg: OscarConfig, model: DiT,
             sched: NoiseSchedule, *, ragged: bool = False,
             compaction: int | str | None = None, topology=None,
             hosts: int | None = None, tracer=None) -> SynthesisService:
    """The service a baseline's D_syn goes through, with ``oscar.
    synthesize``'s precedence: a caller's ``engine`` beats a shared
    ``service``, else a new engine.  ``ragged``, ``compaction``,
    ``topology``/``hosts`` and ``tracer`` switch the chosen engine on,
    never off."""
    knobs = dict(ragged=ragged, compaction=compaction, topology=topology,
                 hosts=hosts, tracer=tracer)
    if engine is not None:
        return SynthesisService(engine.opt_in(**knobs))
    if service is not None:
        service.engine.opt_in(**knobs)
        return service
    return SynthesisService(SynthesisEngine(
        model, sched, image_size=ocfg.data.image_size,
        channels=ocfg.data.channels, **knobs))


def run_fedcado(key, ocfg: OscarConfig, data, model: DiT,
                sched: NoiseSchedule, *, classifier: str | None = None,
                samples_per_category=None, local_steps: int = 200,
                engine: SynthesisEngine | None = None,
                service: SynthesisService | None = None,
                ragged: bool = False, compaction: int | str | None = None,
                topology=None, hosts: int | None = None, tracer=None):
    """Returns (global model, metrics, upload per client, (D_syn images,
    labels)).  Client r's classifier is initialised and trained from
    ``fold_in(kloop, r)``; each of its categories becomes one
    classifier-guided request of group ``("fedcado", r)``."""
    classifier = classifier or ocfg.classifier
    k_samples = samples_per_category or ocfg.samples_per_category
    R = data.client_images.shape[0]
    C = data.num_categories
    device = model.null_y.device
    key, kloop = prng.split(np.asarray(key, np.uint32))

    # --- client side: train + upload full classifiers ---
    client_models = []
    for r in range(R):
        kr = prng.fold_in(kloop, r)
        p = init_classifier(kr, classifier, C, device=device)
        client_models.append(train_classifier(
            p, classifier, data.client_images[r], data.client_labels[r], kr,
            steps=local_steps))
    upload = classifier_param_count(client_models[0])

    # --- server side: classifier-guided generation (Eq. 4).  A client's
    # requests share its classifier, so they share grouped waves; with
    # ``ragged`` they ride merged waves beside classifier-free traffic
    svc = _service(service, engine, ocfg, model, sched, ragged=ragged,
                   compaction=compaction, topology=topology, hosts=hosts,
                   tracer=tracer)
    fut_cat = []
    for r in range(R):
        logprob = classifier_logprob(client_models[r])
        for c in np.unique(np.asarray(data.client_labels[r])):
            fut = svc.submit_classifier_guided(logprob, int(c), k_samples,
                                               group=("fedcado", r))
            fut_cat.append((fut, int(c)))
    key, kgen = prng.split(key)
    syn_x = torch.cat(svc.gather([f for f, _ in fut_cat], kgen))
    syn_y = torch.as_tensor(np.repeat([c for _, c in fut_cat], k_samples),
                            dtype=torch.int64, device=device)

    key, kclf = prng.split(key)
    gp = fit_global(kclf, classifier, C, syn_x, syn_y,
                    steps=ocfg.classifier_steps, batch=ocfg.classifier_batch,
                    device=device)
    metrics = evaluate_per_domain(gp, classifier, data)
    return gp, metrics, upload, (syn_x, syn_y)


def run_feddisc(key, ocfg: OscarConfig, data, model: DiT,
                sched: NoiseSchedule, fm: FrozenFM, *,
                classifier: str | None = None, samples_per_category=None,
                n_prototypes: int = 4, engine: SynthesisEngine | None = None,
                service: SynthesisService | None = None,
                ragged: bool = False, compaction: int | str | None = None,
                topology=None, hosts: int | None = None, tracer=None):
    """Returns (global model, metrics, upload per client, (D_syn images,
    labels)).  Each present (client, category) uploads its statistics;
    the server resamples ``k_samples`` distinct encodings from them
    (numpy's generator, seed 0, as in the reference) and submits them as
    one 2-D request."""
    classifier = classifier or ocfg.classifier
    k_samples = samples_per_category or ocfg.samples_per_category
    R = data.client_images.shape[0]
    C = data.num_categories
    D = ocfg.encoding_dim
    device = model.null_y.device

    # --- client side: per-category feature statistics ---
    means = np.zeros((R, C, D), np.float32)
    stds = np.zeros((R, C, D), np.float32)
    present = np.zeros((R, C), bool)
    for r in range(R):
        with torch.inference_mode():
            z = fm(torch.as_tensor(data.client_images[r],
                                   device=device)).cpu().numpy()
        y = np.asarray(data.client_labels[r])
        for c in range(C):
            m = y == c
            if m.sum() == 0:
                continue
            present[r, c] = True
            means[r, c] = z[m].mean(0)
            stds[r, c] = z[m].std(0) + 1e-4
    # mean + std + n_prototypes exemplar features per category
    upload = (2 + n_prototypes) * C * D

    # --- server side: resample encodings, generate with the CF-DM; each
    # (client, category)'s k_samples distinct rows are ONE 2-D request
    svc = _service(service, engine, ocfg, model, sched, ragged=ragged,
                   compaction=compaction, topology=topology, hosts=hosts,
                   tracer=tracer)
    rng = np.random.default_rng(0)
    futs, labels = [], []
    for r in range(R):
        for c in range(C):
            if not present[r, c]:
                continue
            eps = rng.normal(size=(k_samples, D)).astype(np.float32)
            smp = means[r, c] + 0.5 * stds[r, c] * eps
            smp /= np.linalg.norm(smp, axis=-1, keepdims=True) + 1e-6
            futs.append(svc.submit(smp, int(c)))
            labels.append(np.full((k_samples,), c, np.int64))
    key = np.asarray(key, np.uint32)
    key, kgen = prng.split(key)
    if futs:
        syn_x = torch.cat(svc.gather(futs, kgen))
    else:
        size, ch = ocfg.data.image_size, ocfg.data.channels
        syn_x = torch.zeros((0, size, size, ch), device=device)
    syn_y = torch.as_tensor(np.concatenate(labels) if labels
                            else np.zeros((0,), np.int64), device=device)

    key, kclf = prng.split(key)
    if len(syn_x) == 0:
        # all-absent present mask: no D_syn, so broadcast the untrained init
        gp = init_classifier(kclf, classifier, C, device=device)
    else:
        gp = fit_global(kclf, classifier, C, syn_x, syn_y,
                        steps=ocfg.classifier_steps,
                        batch=ocfg.classifier_batch, device=device)
    metrics = evaluate_per_domain(gp, classifier, data)
    return gp, metrics, upload, (syn_x, syn_y)
