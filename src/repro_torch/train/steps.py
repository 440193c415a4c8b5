"""The LM zoo's train step: the JAX package's ``train/steps.py``.

``init_train_state(key, cfg, device=)`` draws the reference's initial
weights (``init_lm``) into an ``LM`` whose parameters are fp32 master
weights, as the reference's leaves are (each layer casts its weights to the
activation dtype at use), beside zero AdamW moments.
``make_train_step(cfg, par, lr=, weight_decay=, clip_norm=)`` returns
``train_step(state, batch) -> (state, metrics)``: the loss and its
gradients, global-norm clipping, AdamW (``optim/optimizers.py``, the
reference's arithmetic), metrics ``loss, ce, aux, grad_norm`` as 0-d
tensors on the LM's device.

Training runs the plain route, as the reference's does
(``Parallel.use_pallas`` off): the CUDA kernels have no backward, so a
step that asks for them with grad on raises where a kernel would launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM, init_lm, loss_fn
from repro_torch.optim.optimizers import (AdamWState, adamw, apply_updates,
                                          clip_by_global_norm, init_adamw)


class TrainState(NamedTuple):
    """``params``: the LM, its parameters the fp32 master weights (the
    step writes the new values into them); ``opt``: AdamW's moments, a
    dict keyed as ``params.named_parameters()``."""
    params: LM
    opt: AdamWState


def init_train_state(key, cfg: ModelConfig, device=None) -> TrainState:
    """The reference's ``init_train_state``: ``init_lm(key, cfg)`` in
    fp32 on ``device`` (the card unless the caller passes ``"cpu"``) and
    zero moments."""
    lm = init_lm(key, cfg, device=device, param_dtype=torch.float32)
    return TrainState(lm, init_adamw(_leaves(lm)))


def _leaves(lm: LM) -> dict:
    return {k: v.detach() for k, v in lm.named_parameters()}


def make_train_step(cfg: ModelConfig,
                    par: Parallel = Parallel(use_kernels=False), *,
                    lr=3e-4, weight_decay: float = 0.1,
                    clip_norm: float = 1.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``, one AdamW
    step on ``loss_fn`` of the reference's batch dict.  A parameter the
    loss does not read (an encoder's token table) takes a zero gradient,
    as under ``jax.grad``.  The returned state holds the same LM, its
    parameters updated in place, and the new moments."""

    def train_step(state: TrainState, batch):
        lm = state.params
        if lm.cfg != cfg:
            raise ValueError(f"train_step for {cfg.name} got an LM of "
                             f"{lm.cfg.name}")
        names, leaves = zip(*lm.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(lm, batch, par)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, leaves, grads)}
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            params = _leaves(lm)
            updates, opt = adamw(grads, state.opt, params, lr=lr,
                                 weight_decay=weight_decay)
            torch._foreach_copy_(list(params.values()), list(
                apply_updates(params, updates).values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(lm, opt), dict(metrics, loss=loss.detach(),
                                         grad_norm=gnorm)

    return train_step
