"""DDPM training (Eq. 3) with classifier-free conditioning dropout, from the
JAX package's ``diffusion/ddpm.py``.

``pretrain_dm`` plays the role of Stable Diffusion's web-scale
pre-training: the DM is trained once on a broad distribution (the union
of all domains), then frozen; the FL experiments never update it.

Keys, as in the reference: a loss draws ``kt, kn, kd, kg = split(key, 4)``
(t from ``randint(kt, (B,), 0, T)``, the noise from ``normal(kn, x0
.shape)``, the group switch from ``bernoulli(kg, group_cond_prob)`` and
then the drop from ``bernoulli(kd, cond_drop_prob)``); ``pretrain_dm``
splits ``kinit, kloop`` and each step ``kloop, kb, ks = split(kloop, 3)``
with the batch ``randint(kb, (min(B, N),), 0, N)``.  The draws are jax's
(bit for bit, the normals within 3 ulps); ``pretrain_dm`` makes a chunk of
steps' draws in one call each, which changes no value.

The DiT trains on its plain route (``DiT.plain``), as the reference trains
with ``use_pallas=False``: the kernels have no backward and their
wrappers refuse grad.  The model ``pretrain_dm`` returns has ``plain``
cleared, so it samples through the kernels like any other DiT.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from repro_torch import prng
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.diffusion.dit import DiT, init_dit
from repro_torch.diffusion.schedule import (NoiseSchedule, make_schedule,
                                            q_sample)
from repro_torch.optim.optimizers import adamw, apply_updates, init_adamw
from repro_torch.utils import resolve_device

CHUNK = 100        # pretraining steps whose draws are made in one call


def _loss(model: DiT, params: dict, sched: NoiseSchedule, x0, y, y_group,
          t, noise, use_g, drop):
    """Eq. 3 on given draws, through ``functional_call`` on ``params``."""
    x_t = q_sample(sched, x0, t.long(), noise)
    y_in = y
    if y_group is not None:
        y_in = torch.where(use_g[:, None], y_group, y_in)
    y_in = torch.where(drop[:, None], params["null_y"][None], y_in)
    eps = functional_call(model, params, (x_t, t, y_in))
    return torch.mean(torch.square(eps - noise))


def loss_draws(keys, B: int, shape, dc: DiffusionConfig, T: int, device):
    """A loss's draws (t, noise, use_g, drop) for every key of the batch
    ``keys`` (..., 2), each of the four in one call: ``shape`` is x0's."""
    kt, kn, kd, kg = (prng.split(keys, 4)[..., i, :] for i in range(4))
    return (prng.randint(kt, (B,), 0, T, device),
            prng.normal(kn, shape, device),
            prng.bernoulli(kg, dc.group_cond_prob, (B,), device),
            prng.bernoulli(kd, dc.cond_drop_prob, (B,), device))


def diffusion_loss(model: DiT, dc: DiffusionConfig, sched: NoiseSchedule,
                   x0, y, key, y_group=None):
    """Eq. 3: E ||ε − ε_θ(x_t, t, y)||², the conditioning dropped with
    probability ``dc.cond_drop_prob`` (classifier-free training).

    ``y_group`` (optional): each sample's (category × domain) group mean
    encoding, taken in place of its own with probability
    ``dc.group_cond_prob``: the ȳ_c statistic clients upload (Eq. 7).
    Differentiable in the model's parameters; runs on the model's
    device."""
    params = dict(model.named_parameters())
    device = params["null_y"].device
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    if y_group is not None:
        y_group = torch.as_tensor(y_group, dtype=torch.float32, device=device)
    draws = loss_draws(np.asarray(key, np.uint32), x0.shape[0], x0.shape,
                       dc, sched.T, device)
    return _loss(model, params, sched, x0, y, y_group, *draws)


def make_dm_train_step(model: DiT, dc: DiffusionConfig,
                       sched: NoiseSchedule):
    """``step(params, opt, x0, y, y_group, draws) -> (params, opt, loss)``:
    one AdamW step (lr ``dc.lr``, no weight decay) of the loss on the
    given draws (t, noise, use_g, drop); the loss stays on the device."""
    def step(params, opt, x0, y, y_group, draws):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = _loss(model, leaves, sched, x0, y, y_group, *draws)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            updates, opt = adamw(dict(zip(leaves, grads)), opt, params,
                                 lr=dc.lr, weight_decay=0.0)
            return apply_updates(params, updates), opt, loss.detach()
    return step


def group_means(conds, groups) -> np.ndarray:
    """Each sample's (category × domain) group mean encoding, renormalised,
    on the host as the reference computes it: the sums in float32, the
    division by the integer counts (and so the norm) in float64, rounded
    to float32 at the end, where the reference moves them to the device:
    (N, cond_dim) float32."""
    conds = np.asarray(conds, np.float32)
    groups = np.asarray(groups)
    G = int(groups.max()) + 1
    gm = np.zeros((G, conds.shape[-1]), np.float32)
    np.add.at(gm, groups, conds)
    cnt = np.bincount(groups, minlength=G)[:, None].clip(1)
    gm = gm / cnt
    gm /= np.linalg.norm(gm, axis=-1, keepdims=True) + 1e-6
    return gm[groups].astype(np.float32)


def pretrain_dm(key, dc: DiffusionConfig, images, conds, *,
                image_size: int, channels: int, steps: int | None = None,
                log_every: int = 0, groups=None, device=None):
    """Pre-train the classifier-free DM on (images, cond encodings), on
    ``device`` (the card unless the caller passes ``"cpu"``).

    images: (N, H, W, C) in [-1, 1]; conds: (N, cond_dim); groups:
    optional (N,) int group ids (category × domain), which turn on
    group-mean conditioning (``diffusion_loss``).  Returns (model,
    schedule, losses), the losses as (step, loss) pairs read from the
    device once at the end."""
    device = resolve_device(device)
    steps = steps or dc.pretrain_steps
    sched = make_schedule(dc.train_timesteps, dc.schedule, device=device)
    kinit, kloop = prng.split(np.asarray(key, np.uint32))
    model = init_dit(kinit, dc, image_size, channels, device=device)
    model.plain = True
    params = {k: v.detach() for k, v in model.named_parameters()}
    opt = init_adamw(params)
    step = make_dm_train_step(model, dc, sched)
    N = images.shape[0]
    B = min(dc.batch_size, N)
    images = torch.as_tensor(np.asarray(images, np.float32), device=device)
    conds_np = np.asarray(conds, np.float32)
    group_conds = (torch.as_tensor(group_means(conds_np, groups),
                                   device=device)
                   if groups is not None else None)
    conds = torch.as_tensor(conds_np, device=device)
    # the chain of loop keys on the host: kloop, kb, ks = split(kloop, 3)
    kb, ks = np.empty((steps, 2), np.uint32), np.empty((steps, 2), np.uint32)
    for i in range(steps):
        kloop, kb[i], ks[i] = prng.split(kloop, 3)
    losses = []
    for c0 in range(0, steps, CHUNK):
        n = min(CHUNK, steps - c0)
        idx = prng.randint(kb[c0:c0 + n], (B,), 0, N, device).long()
        t, noise, use_g, drop = loss_draws(
            ks[c0:c0 + n], B, (B, *images.shape[1:]), dc, sched.T, device)
        for j in range(n):
            b = idx[j]
            params, opt, loss = step(
                params, opt, images[b], conds[b],
                None if group_conds is None else group_conds[b],
                (t[j], noise[j], use_g[j], drop[j]))
            losses.append(loss)
            if log_every and ((c0 + j) % log_every == 0
                              or c0 + j == steps - 1):
                print(f"  [dm-pretrain] step {c0 + j:5d} loss "
                      f"{float(loss):.4f}", flush=True)
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(params[k])
    model.plain = False
    values = torch.stack(losses).tolist() if losses else []
    return model, sched, list(enumerate(values))

