"""Plain PyTorch versions of the MoE's compact expert pass over the layout
of ``models/moe.py::compact_dispatch``: each group's FFN over its rows and
the combine, what the kernels of ``csrc/moe.cu`` compute, a group at a
time."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe.kernel import BM
# a module import: models/moe.py imports this package's wrappers
from repro_torch.models import moe as moe_model


def _groups(tile_start):
    """(group, first row, end row) of every group that holds rows (a host
    read of ``tile_start``: the plain version syncs)."""
    ts = [int(v) * BM for v in tile_start.tolist()]
    return [(g, lo, hi) for g, (lo, hi) in enumerate(zip(ts, ts[1:]))
            if hi > lo]


def expert_up(x, rows, tile_start, up, gate, act: str, group_div: int,
              tiles_max: int):
    """(tiles_max·BM, fe) in x's dtype: each compact row's up (and gate)
    products and activation as ``models/moe.py::expert_ffn`` rounds them,
    the weights of expert g // group_div for group g; zeros past the last
    group.  x (rows of x, d); up, gate (E, d, fe)."""
    dt = x.dtype
    h = x.new_zeros((tiles_max * BM, up.shape[-1]))
    for g, lo, hi in _groups(tile_start):
        r = rows[lo:hi].long()
        xg = torch.where((r >= 0)[:, None], x[r.clamp(min=0)], 0)
        e = g // group_div
        u = xg @ up[e].to(dt)
        h[lo:hi] = (moe_model._act(xg @ gate[e].to(dt), act) * u
                    if gate is not None else moe_model._act(u, act))
    return h


def expert_down(h, tile_start, down, group_div: int, tiles_max: int):
    """(tiles_max·BM, d): each compact row of h times its group's expert's
    down weights (E, fe, d); zeros past the last group."""
    y = h.new_zeros((tiles_max * BM, down.shape[-1]))
    for g, lo, hi in _groups(tile_start):
        y[lo:hi] = h[lo:hi] @ down[g // group_div].to(h.dtype)
    return y


def combine(y, pair_rows, pair_gates):
    """(tokens, d) in y's dtype: each token's rows of y named by
    ``pair_rows`` (-1: none), weighted by its gates in y's dtype, summed in
    column order, one rounding a product and an add: the first term as it
    is, a pair without a row adding +0 (``models/moe.py``'s gather-add)."""
    wgt = pair_gates.to(y.dtype)
    out = None
    for j in range(pair_rows.shape[1]):
        r = pair_rows[:, j].long()
        term = torch.where((r >= 0)[:, None],
                           y[r.clamp(min=0)] * wgt[:, j, None], 0)
        out = term if out is None else out + term
    return out
