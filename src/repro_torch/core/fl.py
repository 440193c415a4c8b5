"""Multi-round FL baselines: Local, FedAvg, FedProx, FedDyn.

All baselines share one local-SGD pass parameterised by the proximal and
dynamic-regularisation terms:

  FedAvg  (McMahan et al.):  plain local SGD, server averages.
  FedProx (Li et al.):       + μ/2·||w − w_g||².
  FedDyn  (Acar et al.):     + linear correction −⟨h_r, w⟩ + α/2·||w − w_g||²,
                             h_r ← h_r − α(w_r − w_g); server subtracts the
                             running mean of h.

The reference vmaps the local pass over clients; here it is a loop over
them, each client's model run through ``torch.func.functional_call`` on
a dict of tensors by parameter name (the names of
``convert.classifier_state_from_jax``).  Parameters, h and the global
model pair by those names.  As in the reference, every client trains
every round, and participation masks only the aggregation and FedDyn's h
update; FedDyn's server correction averages all clients' local models.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.classifier_train import (as_data, batch_indices,
                                               evaluate, evaluate_per_domain,
                                               functional_xent, param_dict,
                                               sgd_steps,
                                               train_classifier, with_params)
from repro_torch.models.classifiers import init_classifier
from repro_torch.utils import resolve_device


def _sq_dist(params: dict, ref: dict):
    return sum(torch.sum(torch.square(params[k] - ref[k])) for k in params)


def _local_sgd(model, global_params: dict, h_state: dict, images, labels,
               idx, *, lr=0.05, mu=0.0, alpha=0.0):
    """One client's local pass over the batches ``idx`` (steps, batch).
    mu: FedProx proximal; alpha: FedDyn.  Returns (params, new h)."""
    def local_loss(p, xb, yb):
        loss = functional_xent(model, p, xb, yb, 0.0)
        if mu > 0:
            loss = loss + 0.5 * mu * _sq_dist(p, global_params)
        if alpha > 0:
            lin = sum(torch.sum(h_state[k] * p[k]) for k in p)
            loss = loss - lin + 0.5 * alpha * _sq_dist(p, global_params)
        return loss

    params = sgd_steps(model, dict(global_params), images, labels, idx,
                       lr=lr, momentum=0.9, loss_fn=local_loss)
    new_h = h_state
    if alpha > 0:
        new_h = {k: h_state[k] - alpha * (params[k] - global_params[k])
                 for k in h_state}
    return params, new_h


def run_fl(key, data, *, name="resnet18", method="fedavg", rounds=10,
           local_steps=20, batch=32, lr=0.05, mu=0.1, alpha=0.1,
           eval_every=0, participation: float = 1.0, device=None):
    """Multi-round FL on ``device`` (the card unless the caller passes
    ``"cpu"``).  Returns (global model, metrics, uploads_per_client).

    uploads_per_client: parameters uploaded by EACH client over the whole
    run (rounds × |w|, averaged over clients): the Table IV quantity.

    ``participation`` < 1 simulates client dropout: each round a
    Bernoulli(participation) subset of clients is aggregated (numpy's
    generator seeded from ``randint(kinit, (), 0, 2**31 - 1)``, as in the
    reference)."""
    device = resolve_device(device)
    R = data.client_images.shape[0]
    C = data.num_categories
    key = np.asarray(key, np.uint32)
    kinit, kloop = prng.split(key)
    model = init_classifier(kinit, name, C, device=device)
    global_params = param_dict(model)
    n_params = sum(p.numel() for p in global_params.values())

    mu_eff = mu if method == "fedprox" else 0.0
    alpha_eff = alpha if method == "feddyn" else 0.0
    h = [{k: torch.zeros_like(p) for k, p in global_params.items()}
         for _ in range(R)]
    h_server = {k: torch.zeros_like(p) for k, p in global_params.items()}

    shards = [as_data(data.client_images[r], data.client_labels[r], device)
              for r in range(R)]
    n_local = data.client_images.shape[1]
    history = []
    seed = int(prng.randint(kinit, (), 0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    total_uploads = 0
    for rnd in range(rounds):
        kloop, kr = prng.split(kloop)
        keys = prng.split(kr, R)
        if participation < 1.0:
            mask = rng.random(R) < participation
            if not mask.any():
                mask[rng.integers(0, R)] = True
        else:
            mask = np.ones(R, bool)
        total_uploads += int(mask.sum())
        idx = batch_indices(keys, local_steps, batch, n_local, device)
        locals_, h_new = [], []
        for r in range(R):
            p, hr = _local_sgd(model, global_params, h[r], *shards[r],
                               idx[r], lr=lr, mu=mu_eff, alpha=alpha_eff)
            locals_.append(p)
            h_new.append(hr)
        # only participants contribute updates and FedDyn state
        h = [h_new[r] if mask[r] else h[r] for r in range(R)]
        w = torch.as_tensor(mask, dtype=torch.float32, device=device)
        wsum = float(mask.sum())
        stacked = {k: torch.stack([lw[k] for lw in locals_])
                   for k in global_params}
        mean_w = {k: torch.tensordot(w, s, dims=1) / wsum
                  for k, s in stacked.items()}
        if method == "feddyn":
            for k, s in stacked.items():
                delta = torch.mean(s, 0) - global_params[k]
                h_server[k] = h_server[k] - alpha_eff * delta
            global_params = {k: mean_w[k] - h_server[k] / alpha_eff
                             for k in mean_w}
        else:
            global_params = mean_w
        if eval_every and (rnd + 1) % eval_every == 0:
            acc = evaluate_per_domain(with_params(model, global_params),
                                      name, data)["avg"]
            history.append((rnd + 1, acc))
    final = with_params(model, global_params)
    metrics = evaluate_per_domain(final, name, data)
    uploads = n_params * total_uploads // R   # avg per client
    return final, dict(metrics, history=history), uploads


def run_local_only(key, data, *, name="resnet18", steps=200, batch=32,
                   lr=0.05, device=None):
    """Per-client standalone training (the paper's 'Local' row): each
    client's model, initialised and trained from ``fold_in(key, r)``, is
    evaluated on its own domain's test set; 'avg' is the mean of those
    accuracies.  Upload = 0."""
    device = resolve_device(device)
    R = data.client_images.shape[0]
    C = data.num_categories
    key = np.asarray(key, np.uint32)
    metrics, accs = {}, []
    for r in range(R):
        kr = prng.fold_in(key, r)
        params = init_classifier(kr, name, C, device=device)
        params = train_classifier(params, name, data.client_images[r],
                                  data.client_labels[r], kr, steps=steps,
                                  batch=batch, lr=lr)
        xi, yi = data.client_test_set(r)
        acc = evaluate(params, name, xi, yi)
        metrics[f"client{r + 1}"] = acc
        accs.append(acc)
    metrics["avg"] = sum(accs) / len(accs)
    return None, metrics, 0
