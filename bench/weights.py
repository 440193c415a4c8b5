"""Weights drawn from the seed on the device, in the dtype they are served in.

A configuration's reference module lists its weights as groups
(``weight_groups(cfg)``: a dtype and (name, shape, std) triples).  Group g
is one ``torch.randn`` call on a ``torch.Generator`` seeded from (seed, g),
its slices scaled by their std.  The program is loaded from these tensors
by name, and the reference draws any group again on its own, bit for bit
the same, so it takes no weight from the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and tags."""
    ss = np.random.SeedSequence([int(seed), *tags])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def draw_group(group: dict, seed: int, index: int, device) -> dict:
    """Group ``index`` of a configuration's weights: name → tensor."""
    dtype = getattr(torch, group["dtype"])
    sizes = [math.prod(shape) for _, shape, _ in group["tensors"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 7, index))
    flat = torch.randn(sum(sizes), dtype=dtype, device=device, generator=gen)
    out, at = {}, 0
    for (name, shape, std), n in zip(group["tensors"], sizes):
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def fill_module(module: torch.nn.Module, groups: list, seed: int) -> None:
    """Copy every group into ``module``'s parameters of the same names, one
    group at a time; every parameter must be named by exactly one entry,
    with its shape."""
    state = dict(module.named_parameters())
    named = [n for g in groups for n, _, _ in g["tensors"]]
    if sorted(named) != sorted(state):
        missing = sorted(set(state) - set(named))
        extra = sorted(set(named) - set(state))
        raise ValueError(f"weight groups do not name the module's "
                         f"parameters: missing {missing[:5]}, extra "
                         f"{extra[:5]}")
    device = next(iter(state.values())).device
    with torch.no_grad():
        for i, g in enumerate(groups):
            for name, t in draw_group(g, seed, i, device).items():
                p = state[name]
                if p.shape != t.shape:
                    raise ValueError(f"{name}: drawn {tuple(t.shape)}, the "
                                     f"module holds {tuple(p.shape)}")
                p.copy_(t)
