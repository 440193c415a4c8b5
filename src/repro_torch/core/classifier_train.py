"""Classifier training and evaluation: the server's global model (OSCAR,
FedCADO, FedDISC) and the FL baselines' local models.

A classifier's parameters are the ``nn.Module`` of the zoo
(``models/classifiers.py``); the trainers keep them as a dict of tensors
by parameter name and run the module through
``torch.func.functional_call``, and return a new module, leaving the one
they were given as it was.

Keys, as in the reference: step ``i`` trains on the batch
``randint(fold_in(key, i), (batch,), 0, N)``, bit for bit jax's indices;
all steps' indices are drawn in one call before the loop.  A model
initialised from a key (``init_classifier``) holds the weights the
reference's ``init_classifier`` draws from that key (within a few ulps),
drawn on the CPU, so they are the same on every device.

Two runs from one key give the same bits on the card: cuDNN is held to
its deterministic algorithms while gradients are taken, and the loss is
``F.cross_entropy`` (the reference's ``take_along_axis`` as a ``gather``
would scatter in its backward).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch import prng
from repro_torch.models.classifiers import init_classifier
from repro_torch.optim.optimizers import apply_updates, init_sgdm, sgdm
from repro_torch.utils import deterministic_cudnn, resolve_device


def param_dict(model: torch.nn.Module) -> dict:
    """The model's parameters by name, detached copies."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def with_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """A copy of ``model`` holding ``params`` (a dict by parameter name)."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for k, v in out.named_parameters():
            v.copy_(params[k])
    return out


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def as_data(images, labels, device):
    """Images as float32 and labels as int64 on ``device``; images drawn
    under inference mode become normal tensors, which autograd may save."""
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    if images.is_inference():
        images = images.clone()
    return images, torch.as_tensor(labels, dtype=torch.int64, device=device)


def batch_indices(keys, steps: int, batch: int, n: int, device):
    """Every step's batch for each key of the batch ``keys`` (..., 2):
    ``randint(fold_in(key, i), (batch,), 0, n)`` for i < steps, as an
    int64 tensor (..., steps, batch), in one draw."""
    keys = np.asarray(keys, np.uint32)
    step_keys = prng.fold_in(keys[..., None, :], np.arange(steps))
    return prng.randint(step_keys, (batch,), 0, n, device).long()


def functional_xent(model, params: dict, images, labels, l2: float):
    """``xent`` of ``model`` run on ``params`` (a dict by parameter name)
    through ``functional_call``."""
    logits = functional_call(model, params, (images,))
    loss = F.cross_entropy(logits, labels)
    if l2:
        loss = loss + l2 * sum(torch.sum(torch.square(w))
                               for w in params.values())
    return loss


def xent(params, name, images, labels, *, l2: float = 0.0):
    """Mean cross-entropy of the classifier ``params`` on (images, labels),
    plus ``l2 · Σ w²`` over its parameters.  Differentiable in the
    module's parameters.  ``name`` is kept for the reference's signature."""
    device = _device(params)
    images, labels = as_data(images, labels, device)
    return functional_xent(params, dict(params.named_parameters()), images,
                           labels, l2)


def sgd_steps(model, params: dict, images, labels, idx, *, lr: float,
              momentum: float, loss_fn=None) -> dict:
    """SGD with momentum (weight decay 1e-4) from ``params`` over the
    batches ``idx`` (steps, batch); ``loss_fn(params, xb, yb)`` defaults
    to the cross-entropy.  Gradients are taken with deterministic cuDNN.
    Returns the final params."""
    if loss_fn is None:
        def loss_fn(p, xb, yb):
            return functional_xent(model, p, xb, yb, 0.0)
    opt = init_sgdm(params)
    for i in range(idx.shape[0]):
        xb, yb = images[idx[i]], labels[idx[i]]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad(), deterministic_cudnn():
            grads = torch.autograd.grad(loss_fn(leaves, xb, yb),
                                        list(leaves.values()))
        with torch.no_grad():
            updates, opt = sgdm(dict(zip(leaves, grads)), opt, params, lr=lr,
                                momentum=momentum, weight_decay=1e-4)
            params = apply_updates(params, updates)
    return params


def train_classifier(params, name, images, labels, key, *, steps: int = 300,
                     batch: int = 64, lr: float = 0.05,
                     momentum: float = 0.9):
    """``steps`` steps of SGD with momentum on a fixed in-memory dataset,
    on the module's device.  Returns the trained classifier (a new
    module)."""
    device = _device(params)
    images, labels = as_data(images, labels, device)
    idx = batch_indices(key, steps, batch, images.shape[0], device)
    trained = sgd_steps(params, param_dict(params), images, labels, idx,
                        lr=lr, momentum=momentum)
    return with_params(params, trained)


@torch.inference_mode()
def predict(params, name, images):
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=_device(params))
    return torch.argmax(params(images), dim=-1)


def evaluate(params, name, images, labels, batch: int = 256) -> float:
    """Accuracy over (images, labels), in batches of ``batch``."""
    device = _device(params)
    n = len(images)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                             device=device)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, n, batch):
        pred = predict(params, name, images[i:i + batch])
        correct += torch.sum(pred == labels[i:i + batch])
    return int(correct) / max(n, 1)


def evaluate_per_domain(params, name, data) -> dict:
    """Global and per-client (= per-domain) test accuracy, Table I's
    layout: ``avg`` and ``client1`` … ``clientR``."""
    res = {"avg": evaluate(params, name, data.test_images, data.test_labels)}
    for r in range(data.num_domains):
        xi, yi = data.client_test_set(r)
        res[f"client{r + 1}"] = evaluate(params, name, xi, yi)
    return res


def fit_global(key, name, num_classes, images, labels, *, steps=400,
               batch=64, lr=0.05, device=None):
    """Initialise from ``key`` and train on (images, labels): the server's
    global model, on ``device`` (the card unless the caller passes
    ``"cpu"``)."""
    device = resolve_device(device)
    params = init_classifier(key, name, num_classes, device=device)
    return train_classifier(params, name, images, labels, key, steps=steps,
                            batch=batch, lr=lr)
