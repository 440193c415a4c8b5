"""Optimizers over trees of tensors: AdamW, SGD with momentum, global-norm
clipping and a cosine schedule, with the JAX package's arithmetic.

A tree is a dict (a module's ``named_parameters``, as the trainers keep
it) or a list of tensors; the functions return new trees of the same kind
and never write into their arguments.  Each elementwise formula keeps the
reference's association: SGD's momentum is ``(momentum·m + g) + wd·p``
and its update ``-lr·mom`` (``torch.optim.SGD`` adds ``g + wd·p`` first).
``lr`` may be a number or a function of the step count.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _like(tree, leaves):
    return dict(zip(tree, leaves)) if isinstance(tree, dict) else list(leaves)


class AdamWState(NamedTuple):
    step: int
    mu: object
    nu: object


class SGDMState(NamedTuple):
    step: int
    momentum: object


def init_adamw(params) -> AdamWState:
    zeros = lambda: _like(params, torch._foreach_mul(_leaves(params), 0.0))
    return AdamWState(0, zeros(), zeros())


def adamw(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.0):
    """Returns (updates, new_state)."""
    step = state.step + 1
    if callable(lr):
        lr = float(lr(step))
    g = _leaves(grads)
    mu = torch._foreach_add(torch._foreach_mul(_leaves(state.mu), b1),
                            torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_add(torch._foreach_mul(_leaves(state.nu), b2),
                            torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - b2))
    # the bias corrections in float32, as the reference computes them
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    mhat = torch._foreach_div(mu, bc1)
    vhat = torch._foreach_div(nu, bc2)
    upd = torch._foreach_div(mhat, torch._foreach_add(
        torch._foreach_sqrt(vhat), eps))
    upd = torch._foreach_add(upd, torch._foreach_mul(_leaves(params),
                                                     weight_decay))
    updates = torch._foreach_mul(upd, -lr)
    return (_like(params, updates),
            AdamWState(step, _like(params, mu), _like(params, nu)))


def adamw_update_bound(before: AdamWState, after: AdamWState, *, lr,
                       rel: float, b1=0.9, b2=0.95, eps=1e-8) -> dict:
    """How far a gradient error of ``rel`` times the step's largest
    gradient element can move each element of the AdamW update that took
    ``before`` to ``after`` (``adamw``'s states, dicts keyed alike).  The
    update is lr·m̂/(√v̂ + eps); m̂ and √v̂ each move by at most the
    gradient's error δ, so the update by at most 2·lr·δ/(√v̂ + eps): ~lr
    where the gradient is itself at the error's size (AdamW normalises it),
    ~2·lr·rel where it is the largest.  The step's gradient is
    (mu - b1·mu_before)/(1 - b1).  Returns a dict of tensors like ``nu``:
    the gate that holds two runs of a step to each other when their
    gradients agree to ``rel``."""
    gmax = max(float(((m - b1 * before.mu[k]) / (1 - b1)).abs().max())
               for k, m in after.mu.items())
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(after.step))
    return {k: 2 * lr * rel * gmax / ((v / bc2).sqrt() + eps)
            for k, v in after.nu.items()}


def init_sgdm(params) -> SGDMState:
    return SGDMState(0, _like(params, torch._foreach_mul(_leaves(params),
                                                         0.0)))


def sgdm(grads, state: SGDMState, params, *, lr, momentum=0.9,
         weight_decay=0.0):
    """Returns (updates, new_state): ``mom = momentum·m + g + wd·p`` and
    the update ``-lr·mom``."""
    step = state.step + 1
    if callable(lr):
        lr = float(lr(step))
    mom = torch._foreach_add(
        torch._foreach_add(torch._foreach_mul(_leaves(state.momentum),
                                              momentum), _leaves(grads)),
        torch._foreach_mul(_leaves(params), weight_decay))
    updates = torch._foreach_mul(mom, -lr)
    return _like(params, updates), SGDMState(step, _like(params, mom))


def apply_updates(params, updates):
    return _like(params, torch._foreach_add(
        _leaves(params), [u.to(p.dtype) for p, u in
                          zip(_leaves(params), _leaves(updates))]))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, global norm as a 0-d float32 tensor)."""
    g = _leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in g))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return _like(grads, [x * scale.to(x.dtype) for x in g]), gn


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """``lr(step)``: linear warm-up to ``base_lr``, then a cosine down to
    ``min_frac·base_lr`` at ``total``; a 0-d float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
