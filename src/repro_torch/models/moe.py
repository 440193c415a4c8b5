"""The Mixture-of-Experts FFN of the LM zoo: the JAX package's
``models/moe.py``, its dense and expert-parallel paths, and ``Parallel``,
how the LM is laid out on a mesh.

Routing follows the reference step for step: the router's logits are in
the activation dtype, softmax in fp32, top-k with **the lower expert index
first among equal probabilities** (``jax.lax.top_k``'s order: a stable
descending sort, never ``torch.topk``, which orders ties otherwise; bf16
logits tie often), gates renormalised in fp32, and the Switch load-balance
loss E·Σ f·P.  Each expert takes its first ``capacity`` selected tokens in
token order and drops the rest; ``capacity = max(1, cdiv(T·k, E)·4)`` with
T = B·S, the reference's dense path.

The DeepSeek-V3 block (``configs/base.py::DeepSeekV3Config``; not in the
reference) routes otherwise (``scoring="sigmoid"``): fp32 router logits,
sigmoid scores, experts selected by the top-k of score + ``router_bias``
(the same lower-index-first order), gated by their scores renormalised
over the k and scaled by ``routed_scaling_factor``.  Its shared experts,
one gated MLP every token takes, are added to the routed output inside
``moe_dense`` (and ``moe_ep``).  The expert passes below take either
route's gates as they are.

Two expert passes, chosen by what the call can observe (``compact_route``):

* **compact** (x on a CUDA card in bf16, autograd not recording: serving):
  ``compact_dispatch`` lays out only the kept pairs,
  each (expert, shard) group's rows in token order from a multiple of the
  128-row tile (a stable counting sort of the T·k pairs: no (T, E) one-hot,
  no host sync); ``kernels/moe`` runs the up and gate products with the
  activation (its rows of x gathered on the chip) and the down product over
  those row tiles only, a persistent wgmma kernel each, then one combine
  launch;
* **padded** (CPU tensors, fp32 on the card, training): every expert on its
  ``capacity`` rows at once (``bmm`` over experts, the weights in the
  reference's (E, in, out) layout); a row past an expert's selected tokens
  reads a zero row of x and adds 0.  Its index lists are built on the
  device too (a ``cumsum`` rank per expert).

Both keep the drop set and round where the reference rounds: each expert
product, the activation and the gated product in the activation dtype.  The
combine keeps the reference's arithmetic: ``out`` in the activation dtype
takes each expert's rows in expert order, one rounding an add; here each
token adds its (at most k) expert rows in ascending expert order, which is
the same sequence of adds for every token.  On the compact path a row's
bits depend only on that row and its expert (no split-K), so ``moe_ep``
equals ``moe_dense`` on one card wherever both keep the same pairs.

The expert-parallel path ``moe_ep`` is the reference's ``shard_map`` on
the port's single-controller mesh (``launch/mesh.py``): one process loops
over the mesh's (data, model) shards, with no ``torch.distributed``.
Experts split over the ``model`` axis (E_loc = E / M a shard); tokens
split by batch rows over the data shards (or every shard sees all of
them); each shard routes its own tokens, keeps ``max(1, int(T·k / E ·
capacity_factor))`` rows an expert of its own T, and runs the local pass
over its experts on its device (data shards that share a device, as on
the CPU or the meta device, run as one batched pass: 16 × 16 shards make
16 passes a layer, not 256); the combine sums the model shards in
ascending order, and ``aux`` is the mean over the data shards.
``moe_apply`` takes ``moe_ep`` exactly where the reference does: when
``Parallel`` names a model axis and a mesh.

Under an enabled current tracer (``obs/trace.py``) ``moe_dense`` is a
``moe`` span, and ``route`` and every local expert pass open ``moe.route``
(attribute ``scoring``), ``moe.dispatch`` (the index lists, and on the
padded path the gather of the experts' rows), ``moe.experts`` (the products
and the activation; attribute ``path``, ``"compact"`` or ``"padded"``) and
``moe.combine`` (weighting and sum); the shared experts are
``moe.shared``.  ``moe.dispatch`` carries ``pairs``, the (token, expert)
pairs routed to the pass's experts; ``expert_rows``, the rows its experts
compute (the kept rows rounded up to the row tile on the compact path, a
0-d tensor on the device; E_loc·D·cap on the padded one); and ``dropped``,
the pairs past their expert's capacity, a 0-d tensor on the device (no host
sync), as is ``pairs`` in a pass over some of the experts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import (DeepSeekV3Config, ModelConfig,
                                      MoEConfig)
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.kernels.moe.kernel import BM
from repro_torch.models.layers import MLP
from repro_torch.obs.trace import current


MOE_COMBINES = ("psum", "reduce_scatter")
DECODE_CACHES = ("scan_ys", "carry")


@dataclass(frozen=True)
class Parallel:
    """How the LM runs on a mesh: the reference's ``Parallel``.  None axes
    are not sharded.  On the single-controller mesh the specs
    (``resid_spec``, ``logits_spec``, ``qkv_spec``) are layout records: the
    LM checks their rank and changes no value by them."""
    model_axis: Optional[str] = None   # tensor/expert-parallel axis name
    data_axes: tuple = ()              # batch axes ("pod", "data")
    mesh: object = None                # launch/mesh.py::Mesh
    # Route prefill attention through the flash-attention kernel wrapper,
    # which launches the CUDA kernel for CUDA tensors and runs its plain
    # version for CPU tensors.  On by default, unlike the reference's
    # ``use_pallas=False``: the port's wrappers choose by device.  Off is the
    # plain ``_attend`` (or ``attn_impl="chunked"``) route.
    use_kernels: bool = True
    moe_combine: str = "psum"          # psum | reduce_scatter: the same sum
    batch_sharded: bool = True         # False when batch < data shards
    resid_spec: object = None          # residual stream between groups
    logits_spec: object = None         # the LM logits
    attn_impl: str = "naive"           # naive | chunked (without kernels)
    prefill_last_only: bool = False    # serving: readout last position only
    qkv_spec: object = None            # (q_sharding, kv_sharding)
    gqa_repeat: bool = False           # repeat k and v to num_heads
    decode_cache: str = "scan_ys"      # scan_ys | carry: the same caches

    def __post_init__(self):
        if self.moe_combine not in MOE_COMBINES:
            raise ValueError(f"moe_combine={self.moe_combine!r}, not one of "
                             f"{MOE_COMBINES}")
        if self.decode_cache not in DECODE_CACHES:
            raise ValueError(f"decode_cache={self.decode_cache!r}, not one "
                             f"of {DECODE_CACHES}")

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]


def pin(x, sharding):
    """A spec (or a ``launch/mesh.py::NamedSharding``) pinned on ``x``, as
    the reference's ``with_sharding_constraint``: on the single-controller
    mesh a layout record, checked for rank, that changes no value."""
    if sharding is not None:
        spec = getattr(sharding, "spec", sharding)
        if len(spec) > x.ndim:
            raise ValueError(f"spec {spec} pinned on a {x.ndim}-d tensor")
    return x


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves as parameters, in its layouts:
    ``w_router`` (d, E), ``experts_up`` and ``experts_gate`` (E, d, fe),
    ``experts_down`` (E, fe, d); held in ``dtype``, allocated, not drawn.
    A ``DeepSeekV3Config`` adds ``router_bias`` (E,) in fp32 (sigmoid
    scoring's selection bias) and ``shared`` (an ``MLP`` of
    ``n_shared_experts · fe``).  ``moe_apply(moe, cfg, x, par)`` runs it."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        m = cfg.moe
        d, fe, E = cfg.d_model, m.d_ff_expert, m.num_experts
        kw = dict(device=device, dtype=dtype)
        self.w_router = nn.Parameter(torch.empty((d, E), **kw))
        self.experts_up = nn.Parameter(torch.empty((E, d, fe), **kw))
        self.experts_down = nn.Parameter(torch.empty((E, fe, d), **kw))
        self.experts_gate = (nn.Parameter(torch.empty((E, d, fe), **kw))
                             if cfg.gated_mlp else None)
        self.router_bias = self.shared = None
        self.scoring, self.scale = "softmax", 1.0
        if isinstance(cfg, DeepSeekV3Config):
            self.scoring, self.scale = "sigmoid", cfg.routed_scaling_factor
            self.router_bias = nn.Parameter(torch.zeros(E, device=device))
            if cfg.n_shared_experts:
                self.shared = MLP(d, cfg.n_shared_experts * fe,
                                  cfg.gated_mlp, cfg.mlp_act, **kw)

    def routing(self, device=None) -> dict:
        """``route``'s keywords for this layer (the bias on ``device``)."""
        if self.scoring == "softmax":
            return {}
        return {"scoring": self.scoring, "scale": self.scale,
                "bias": self.router_bias.to(device)}


def top_k_lower_first(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, largest
    first, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(w_router, x_flat, m: MoEConfig, *, scoring: str = "softmax",
          bias=None, scale: float = 1.0):
    """Returns (gates (T, k) fp32, idx (T, k) int64, aux_loss scalar).
    ``x_flat`` may lead with a shard axis, (D, T, d): each shard routes its
    own tokens and has its own aux loss, (D,).  ``scoring="sigmoid"``
    (DeepSeek-V3's): logits in fp32 from x and the router cast to fp32,
    experts chosen by the top-k of sigmoid score + ``bias`` (E,), gates the
    chosen scores over their sum (+ 1e-20) times ``scale``; the aux loss
    takes the scores normalised over the experts as its P."""
    with current().span("moe.route", scoring=scoring):
        if scoring == "sigmoid":
            logits = x_flat.float() @ w_router.float()
            scores = torch.sigmoid(logits)
            _, idx = top_k_lower_first(scores + bias, m.top_k)
            gates = scores.gather(-1, idx)
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * scale
            probs = scores / scores.sum(-1, keepdim=True)
        else:
            logits = (x_flat @ w_router.to(x_flat.dtype)).float()
            probs = torch.softmax(logits, dim=-1)              # (T, E)
            gates, idx = top_k_lower_first(probs, m.top_k)
            gates = gates / gates.sum(-1, keepdim=True)
        # Switch-style load-balance loss: E * sum_e f_e * P_e, f_e the
        # dispatch fraction (an integer count over T, exact as the
        # reference's)
        lead, T = idx.shape[:-2], x_flat.shape[-2]
        flat = idx.reshape(*lead, -1)
        counts = torch.zeros((*lead, m.num_experts), dtype=torch.int64,
                             device=idx.device).scatter_add_(
            -1, flat, torch.ones_like(flat))
        f = counts.float() / T
        aux = m.num_experts * torch.sum(f * probs.mean(-2), -1)
    return gates, idx, aux


def capacity(T: int, m: MoEConfig) -> int:
    """Rows an expert takes in the dense path ("generous: no drops")."""
    return max(1, -(-T * m.top_k // m.num_experts) * 4)


def dispatch(gates, idx, num_experts: int, cap: int, e_start: int = 0,
             E_loc: Optional[int] = None):
    """Each of the experts ``e_start .. e_start + E_loc - 1`` (all
    ``num_experts`` by default) takes its first ``cap`` selected tokens in
    token order.  ``gates`` and ``idx`` are (T, k), or (D, T, k) for D
    shards batched on one device: each shard's experts then take ``cap``
    of that shard's tokens, token t of shard i being row i·T + t.

    Returns (tok (E_loc, D·cap) token rows, D·T where an expert has fewer;
    wgt (E_loc, D·cap) their gates, 0 there; slot (D·T, E_loc) the row
    e·D·cap + i·cap + rank of each kept (token, local expert e) pair in
    the expert pass, E_loc·D·cap where the token did not pick the expert
    or the expert dropped it)."""
    k, T = idx.shape[-1], idx.shape[-2]
    D = idx.numel() // (T * k)
    E_loc = num_experts if E_loc is None else E_loc
    dev = idx.device
    w = torch.zeros((D, T, num_experts), dtype=gates.dtype,
                    device=dev).scatter_(2, idx.reshape(D, T, k),
                                         gates.reshape(D, T, k))
    w = w[..., e_start:e_start + E_loc]
    sel = w > 0
    rank = torch.cumsum(sel, dim=1) - 1                        # (D, T, E_loc)
    keep = sel & (rank < cap)
    base = torch.arange(E_loc, device=dev) * (D * cap)
    if D > 1:
        base = base + (torch.arange(D, device=dev) * cap)[:, None, None]
    n = E_loc * D * cap
    slot = torch.where(keep, base + rank, n)
    rows = torch.arange(D * T, device=dev).view(D, T, 1).expand(D, T, E_loc)
    # the dropped pairs all land on the spare entry n, which is cut off
    tok = torch.full((n + 1,), D * T, dtype=torch.int64,
                     device=dev).scatter_(0, slot.reshape(-1),
                                          rows.reshape(-1))[:n]
    wgt = torch.zeros((n + 1,), dtype=w.dtype, device=dev).scatter_(
        0, slot.reshape(-1), w.reshape(-1))[:n]
    return (tok.view(E_loc, D * cap), wgt.view(E_loc, D * cap),
            slot.reshape(D * T, E_loc))


@dataclass(frozen=True)
class Compact:
    """The compact layout of one expert pass.

    ``rows`` (tiles_max·BM,) int32: the row of x (token i·T + t of shard i)
    each compact row computes, -1 past its group's kept rows;
    ``tile_start`` (G + 1,) int32: group g owns row tiles
    [tile_start[g], tile_start[g + 1]), groups in (expert, shard) order;
    ``pair_rows`` (D·T, k) int32: each token's compact rows in ascending
    expert order, -1 for a pair its expert dropped or that another pass
    owns; ``pair_gates`` (D·T, k) fp32: their gates, in the same order;
    ``group_div``: D, the groups of one expert; ``tiles_max``: the row
    tiles' upper bound, a host number from shapes alone.  ``selected`` (the
    pairs the pass's experts were chosen for, a bool tensor) and ``kept``
    (G,) feed ``counts``."""
    rows: torch.Tensor
    tile_start: torch.Tensor
    pair_rows: torch.Tensor
    pair_gates: torch.Tensor
    group_div: int
    tiles_max: int
    pairs: object
    selected: torch.Tensor
    kept: torch.Tensor

    def counts(self) -> dict:
        """The ``moe.dispatch`` span's counts: ``pairs`` routed to the
        pass's experts, ``expert_rows`` computed (the kept rows rounded up to
        the tile) and ``dropped``, device tensors where they need the
        device (computed only when asked: the span is off by default)."""
        return {"pairs": self.pairs,
                "expert_rows": self.tile_start[-1] * BM,
                "dropped": self.selected.sum() - self.kept.sum()}


def tiles_bound(D: int, T: int, k: int, E_loc: int, cap: int) -> int:
    """The most row tiles D shards of T tokens can fill on E_loc experts
    of ``cap`` rows: Σ_g cdiv(kept_g, BM) ≤ (Σ_g kept_g + G·(BM − 1)) / BM,
    Σ_g kept_g ≤ min(D·T·min(k, E_loc), G·cap)."""
    G = D * E_loc
    kept = min(D * T * min(k, E_loc), G * cap)
    return min(G * -(-cap // BM), (kept + G * (BM - 1)) // BM)


def compact_dispatch(gates, idx, num_experts: int, cap: int,
                     e_start: int = 0, E_loc: Optional[int] = None) -> Compact:
    """``dispatch``'s drop set in a compact layout, for the kernels of
    ``kernels/moe`` (PyTorch glue over the T·k pairs, no host sync).  Each
    of the experts ``e_start .. e_start + E_loc - 1`` takes its first
    ``cap`` selected tokens of each shard in token order, as there;
    ``gates`` and ``idx`` are (T, k) or (D, T, k).  A stable counting sort
    over the pairs: a histogram of the G = E_loc·D groups, an exclusive
    scan of the kept rows rounded up to ``BM``, each pair's rank in token
    order within its group (a stable sort of the pairs by group)."""
    k, T = idx.shape[-1], idx.shape[-2]
    D = idx.numel() // (T * k)
    E_loc = num_experts if E_loc is None else E_loc
    G, P, dev = E_loc * D, D * T * k, idx.device
    loc = idx.reshape(D, T, k)
    if e_start:
        loc = loc - e_start
    sel = gates.reshape(D, T, k) > 0
    pairs = idx.numel()
    if e_start != 0 or E_loc != num_experts:
        here = (loc >= 0) & (loc < E_loc)
        sel = sel & here
        pairs = here.sum()
    if D > 1:
        loc = loc * D + torch.arange(D, device=dev).view(D, 1, 1)
    gid = torch.where(sel, loc, G).reshape(-1)
    sorted_gid, order = torch.sort(gid, stable=True)
    counts = torch.zeros(G + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, gid, torch.ones_like(gid))
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(P, device=dev)
    rank = torch.empty_like(gid).scatter_(0, order, pos - first[sorted_gid])
    keep = sel.reshape(-1) & (rank < cap)
    kept = counts[:G].clamp(max=cap)
    tile_start = F.pad(torch.cumsum((kept + BM - 1) // BM, 0,
                                    dtype=torch.int32), (1, 0))
    row = torch.where(keep, tile_start[gid.clamp(max=G - 1)] * BM + rank, -1)
    tiles_max = tiles_bound(D, T, k, E_loc, cap)
    R = tiles_max * BM
    # the dropped pairs all land on the spare entry R, which is cut off
    rows = torch.full((R + 1,), -1, dtype=torch.int32, device=dev).scatter_(
        0, torch.where(keep, row, R), (pos // k).to(torch.int32))[:R]
    ranked = torch.sort(idx.reshape(-1, k), dim=-1, stable=True).indices
    return Compact(
        rows=rows, tile_start=tile_start,
        pair_rows=row.view(-1, k).gather(1, ranked).to(torch.int32),
        pair_gates=gates.reshape(-1, k).gather(1, ranked).float(),
        group_div=D, tiles_max=tiles_max, pairs=pairs, selected=sel,
        kept=kept)


def dropped_pairs(gates, idx, num_experts: int, cap: int):
    """(..., T, E) bool: the (token, expert) pairs the router chose that
    their expert drops, being past its first ``cap`` selected tokens (of
    each shard, for a leading shard axis)."""
    sel = torch.zeros((*idx.shape[:-1], num_experts), dtype=torch.bool,
                      device=idx.device).scatter_(-1, idx, gates > 0)
    return sel & (torch.cumsum(sel, dim=-2) > cap)


def _act(v, act: str):
    if act == "silu":
        return F.silu(v)
    return F.gelu(v, approximate="tanh")   # jax.nn.gelu's default form


def expert_ffn(xe, up, down, gate, act: str):
    """Every expert's FFN on its rows: xe (E, C, d) → (E, C, d), the
    weights cast to the activation dtype."""
    dt = xe.dtype
    h = torch.bmm(xe, up.to(dt))
    if gate is not None:
        h = _act(torch.bmm(xe, gate.to(dt)), act) * h
    else:
        h = _act(h, act)
    return torch.bmm(h, down.to(dt))


def compact_route(params: MoE, x_flat) -> bool:
    """Whether ``local_expert_pass`` takes the compact path, from what the
    call can observe: x on a CUDA card in bf16, autograd not recording
    (no input needs a gradient, or none is taken).  CPU tensors, fp32 on
    the card and training keep the padded ``bmm`` path; the kernels refuse
    what else they do not take (``kernels/moe/ops.py``)."""
    if x_flat.device.type != "cuda" or x_flat.dtype != torch.bfloat16:
        return False
    ws = [w for w in (params.experts_up, params.experts_gate,
                      params.experts_down) if w is not None]
    return not (torch.is_grad_enabled()
                and (x_flat.requires_grad
                     or any(w.requires_grad for w in ws)))


def local_expert_pass(params: MoE, cfg: ModelConfig, x_flat, e_start: int,
                      E_loc: int, cap: int, gates, idx):
    """Gather → FFN → combine for the ``E_loc`` experts from global id
    ``e_start``, their slabs taken from ``params`` onto x's device:
    (rows, d) in x's dtype, 0 for a token none of them takes.  ``x_flat``
    is (T, d), or (D·T, d) for ``gates`` and ``idx`` of D shards (D, T, k)
    (``dispatch``).  ``compact_pass`` where ``compact_route`` holds, else
    ``padded_pass``."""
    fn = compact_pass if compact_route(params, x_flat) else padded_pass
    return fn(params, cfg, x_flat, e_start, E_loc, cap, gates, idx)


def compact_pass(params: MoE, cfg: ModelConfig, x_flat, e_start: int,
                 E_loc: int, cap: int, gates, idx):
    """``local_expert_pass`` over the kept rows only (``kernels/moe``): on
    the card the kernels, on the CPU their plain versions."""
    m = cfg.moe
    tr = current()
    slab = lambda w: (None if w is None else
                      w[e_start:e_start + E_loc].to(x_flat.device,
                                                    x_flat.dtype))
    with tr.span("moe.dispatch") as sp:
        c = compact_dispatch(gates, idx, m.num_experts, cap, e_start, E_loc)
        if tr.enabled:
            sp.set(**c.counts())
    with tr.span("moe.experts", path="compact"):
        h = moe_ops.expert_up(x_flat, c.rows, c.tile_start,
                              slab(params.experts_up),
                              slab(params.experts_gate), cfg.mlp_act,
                              c.group_div, c.tiles_max)
        y = moe_ops.expert_down(h, c.tile_start, slab(params.experts_down),
                                c.group_div, c.tiles_max)
    with tr.span("moe.combine"):
        return moe_ops.combine(y, c.pair_rows, c.pair_gates)


def padded_pass(params: MoE, cfg: ModelConfig, x_flat, e_start: int,
                E_loc: int, cap: int, gates, idx):
    """``local_expert_pass`` with every expert on its ``cap`` rows of each
    shard (``dispatch``, ``expert_ffn``, ``padded_combine``)."""
    m = cfg.moe
    d = x_flat.shape[1]
    dev = x_flat.device
    tr = current()
    with tr.span("moe.dispatch") as sp:
        tok, wgt, slot = dispatch(gates, idx, m.num_experts, cap, e_start,
                                  E_loc)
        n = tok.numel()
        if tr.enabled:
            sp.set(**_dispatch_counts(gates, idx, slot, n, e_start, E_loc,
                                      m.num_experts))
        # Pad x with a zero row; the fill index points at it.
        x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
        xe = x_pad[tok]
    with tr.span("moe.experts", path="padded"):
        slab = lambda w: (None if w is None else
                          w[e_start:e_start + E_loc].to(dev))
        y = expert_ffn(xe, slab(params.experts_up),
                       slab(params.experts_down), slab(params.experts_gate),
                       cfg.mlp_act)
    with tr.span("moe.combine"):
        return padded_combine(y, wgt, slot, idx, e_start, m.num_experts)


def padded_combine(y, wgt, slot, idx, e_start: int, num_experts: int):
    """The padded path's combine: each token's (at most k) rows of ``y``
    (E_loc, D·cap, d) weighted by ``wgt`` in y's dtype, summed in
    ascending expert order, one rounding a product and an add; an expert of
    another shard, like a dropped pair, adds 0 (the spare row)."""
    E_loc, n, d = slot.shape[1], wgt.numel(), y.shape[-1]
    k = idx.shape[-1]
    y = y * wgt[..., None].to(y.dtype)
    y_pad = torch.cat([y.reshape(n, d), y.new_zeros((1, d))])
    ranked = torch.sort(idx.reshape(-1, k), dim=-1).values
    if E_loc == num_experts:            # every expert here: no mask to build
        rows = slot.gather(1, ranked)
    else:
        loc = ranked - e_start
        here = (loc >= 0) & (loc < E_loc)
        rows = torch.where(here, slot.gather(1, loc.clamp(0, E_loc - 1)), n)
    out = y_pad[rows[:, 0]]
    for j in range(1, k):
        out = out + y_pad[rows[:, j]]
    return out


def _dispatch_counts(gates, idx, slot, n: int, e_start: int, E_loc: int,
                     num_experts: int) -> dict:
    """The ``moe.dispatch`` span's counts: the pairs routed to experts
    ``e_start .. e_start + E_loc - 1``, the rows they compute (``n``) and the
    pairs they drop, which is ``dropped_pairs(...)`` over them summed: the
    chosen pairs less the kept ones (a ``slot`` below ``n``).  Device
    tensors where a count needs the device."""
    chosen = gates > 0
    if E_loc == num_experts:
        pairs = idx.numel()
    else:
        here = (idx >= e_start) & (idx < e_start + E_loc)
        chosen = chosen & here
        pairs = here.sum()
    return {"pairs": pairs, "expert_rows": n,
            "dropped": chosen.sum() - (slot < n).sum()}


def moe_dense(params: MoE, cfg: ModelConfig, x):
    """Single-device path (all experts local).  Returns (out, aux)."""
    B, S, d = x.shape
    tr = current()
    with tr.span("moe"):
        x_flat = x.reshape(B * S, d)
        gates, idx, aux = route(params.w_router, x_flat, cfg.moe,
                                **params.routing())
        out = local_expert_pass(params, cfg, x_flat, 0, cfg.moe.num_experts,
                                capacity(B * S, cfg.moe), gates, idx)
        if params.shared is not None:
            with tr.span("moe.shared"):
                out = out + params.shared(x_flat)
    return out.reshape(B, S, d), aux


def ep_capacity(T: int, m: MoEConfig) -> int:
    """Rows an expert takes on an expert-parallel shard of T tokens: the
    reference's ``max(1, int(T * top_k / num_experts * capacity_factor))``
    in Python floats, in that order."""
    return max(1, int(T * m.top_k / m.num_experts * m.capacity_factor))


def shard_grid(par: Parallel) -> np.ndarray:
    """The mesh's devices as a (data shards, model shards) grid: the data
    axes flattened in ``par.data_axes`` order, the model axis last."""
    mesh = par.mesh
    names = mesh.axis_names
    order = tuple(par.data_axes) + (par.model_axis,)
    if sorted(order) != sorted(names):
        raise ValueError(f"moe_ep needs a mesh of the axes {order}, got "
                         f"{names}")
    devs = np.transpose(mesh.devices, [names.index(a) for a in order])
    return devs.reshape(-1, par.model_size)


def _data_groups(grid: np.ndarray, D: int) -> list:
    """The data shards that run as one batched pass: all D where each model
    shard's data shards lie on one device (a CPU or meta mesh), else each
    alone (a mesh of distinct cards)."""
    if all(len(set(grid[:D, s])) == 1 for s in range(grid.shape[1])):
        return [range(D)]
    return [range(i, i + 1) for i in range(D)]


def moe_ep(params: MoE, cfg: ModelConfig, x, par: Parallel,
           batch_sharded: bool = True):
    """The expert-parallel path on the single-controller mesh.  Returns
    (out, aux) on x's device.

    Experts split over ``par.model_axis``: model shard s holds experts
    ``s·E_loc .. (s+1)·E_loc - 1``.  With ``batch_sharded`` and data axes,
    data shard i takes batch rows ``i·B/D .. (i+1)·B/D - 1``; otherwise every
    shard sees all of them (and the data shards, alike, run once).  Each
    (data, model) shard routes its own tokens on its device and runs its
    local pass at ``ep_capacity`` of its own T; data shards that share a
    device run as one batched pass, each with its own routing, capacity
    and aux (``dispatch``).  The model shards' outputs are summed in
    ascending order (``moe_combine="reduce_scatter"``: each token chunk
    summed on its shard's device in the same order, then gathered: the
    same sum); ``aux`` is the mean over the data shards.  Counts its calls
    in ``moe_ep.calls``; with ``moe_ep.record`` a list, appends each call's
    dropped (token, expert) pair count, a 0-d tensor on x's device (no host
    sync)."""
    moe_ep.calls += 1
    m = cfg.moe
    M = par.model_size
    if m.num_experts % M:
        raise ValueError(f"{m.num_experts} experts over {M} model shards")
    E_loc = m.num_experts // M
    grid = shard_grid(par)
    B, S, d = x.shape
    D = grid.shape[0] if batch_sharded and par.data_axes else 1
    if B % D:
        raise ValueError(f"batch {B} over {D} data shards")
    T = B // D * S
    cap = ep_capacity(T, m)
    xd = x.reshape(D, T, d)
    outs, auxs, drops = [], [], []
    for g in _data_groups(grid, D):
        parts = []
        for s in range(M):
            dev = grid[g[0], s]
            xs = xd[g[0]:g[-1] + 1].to(dev)
            gates, idx, aux = route(params.w_router.to(dev), xs, m,
                                    **params.routing(dev))
            parts.append(local_expert_pass(params, cfg, xs.reshape(-1, d),
                                           s * E_loc, E_loc, cap, gates, idx))
            if s == 0:
                auxs.append(aux.to(x.device))
                if moe_ep.record is not None:
                    drops.append(dropped_pairs(gates, idx, m.num_experts,
                                               cap).sum().to(x.device))
        outs.append(_combine(parts, grid[g[0]], par.moe_combine, len(g),
                             x.device))
    if moe_ep.record is not None:
        moe_ep.record.append(sum(drops))
    aux = torch.cat(auxs)
    out = torch.cat(outs).reshape(B, S, d)
    if params.shared is not None:
        with current().span("moe.shared"):
            out = out + params.shared(x)
    return out, aux.sum() / aux.numel()


moe_ep.calls = 0
moe_ep.record = None


def _combine(parts, devices, how: str, D: int, out_device):
    """The model shards' (D·T, d) outputs summed in ascending shard order:
    ``psum`` on the first shard's device; ``reduce_scatter`` sums token
    chunk j of each data shard on shard j's device, then gathers the
    chunks."""
    def total(rows, dev):
        out = parts[0][rows].to(dev)
        for p in parts[1:]:
            out = out + p[rows].to(dev)
        return out.to(out_device)

    if how == "psum":
        return total(slice(None), devices[0])
    M, (n, d) = len(parts), parts[0].shape
    T = n // D
    if T % M:
        raise ValueError(f"reduce_scatter of {T} tokens over {M} shards")
    c = T // M
    parts = [p.view(D, T, d) for p in parts]
    return torch.cat([total((slice(None), slice(j * c, (j + 1) * c)),
                            devices[j]) for j in range(M)], 1).reshape(n, d)


def moe_apply(params: MoE, cfg: ModelConfig, x, par: Parallel = Parallel()):
    """The reference's dispatch: ``moe_ep`` when ``par`` names a model axis
    and a mesh, else ``moe_dense``.  Returns (out, aux_loss)."""
    if par.model_axis is not None and par.mesh is not None:
        return moe_ep(params, cfg, x, par, batch_sharded=par.batch_sharded)
    return moe_dense(params, cfg, x)
