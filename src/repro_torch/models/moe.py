"""The Mixture-of-Experts FFN of the LM zoo: the JAX package's
``models/moe.py`` on one device, and ``Parallel``, how the LM runs there.

Routing follows the reference step for step: the router's logits are in
the activation dtype, softmax in fp32, top-k with **the lower expert index
first among equal probabilities** (``jax.lax.top_k``'s order: a stable
descending sort, never ``torch.topk``, which orders ties otherwise; bf16
logits tie often), gates renormalised in fp32, and the Switch load-balance
loss E·Σ f·P.  Each expert takes its first ``capacity`` selected tokens in
token order and drops the rest; ``capacity = max(1, cdiv(T·k, E)·4)`` with
T = B·S, the reference's dense path.

The expert pass runs every expert on its ``capacity`` rows at once
(``bmm`` over experts, the weights in the reference's (E, in, out) layout);
a row past an expert's selected tokens reads a zero row of x and adds 0.
The index lists are built on the device (a ``cumsum`` rank per expert), so
a layer makes no host sync.  The combine keeps the reference's arithmetic:
``out`` in the activation dtype takes each expert's rows in expert order,
one rounding an add; here each token adds its (at most k) expert rows in
ascending expert order, which is the same sequence of adds for every
token, in k launches instead of E.

Only the dense path is ported: the reference's expert-parallel ``moe_ep``
(a ``shard_map`` over a ``model`` mesh axis) waits for the mesh fields of
``Parallel``.  On one device the reference serves with ``Parallel()``,
which takes ``moe_dense`` too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig


@dataclass(frozen=True)
class Parallel:
    # Route prefill attention through the flash-attention kernel wrapper,
    # which launches the CUDA kernel for CUDA tensors and runs its plain
    # version for CPU tensors.  On by default, unlike the reference's
    # ``use_pallas=False``: the port's wrappers choose by device.  Off is the
    # plain ``_attend`` (or ``attn_impl="chunked"``) route.
    use_kernels: bool = True
    attn_impl: str = "naive"           # naive | chunked (without kernels)
    prefill_last_only: bool = False    # serving: readout last position only


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves as parameters, in its layouts:
    ``w_router`` (d, E), ``experts_up`` and ``experts_gate`` (E, d, fe),
    ``experts_down`` (E, fe, d); held in ``dtype``, allocated, not drawn.
    ``moe_apply(moe, cfg, x, par)`` runs it."""

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


def top_k_lower_first(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, largest
    first, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(w_router, x_flat, m: MoEConfig):
    """Returns (gates (T, k) fp32, idx (T, k) int64, aux_loss scalar)."""
    logits = (x_flat @ w_router.to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, idx = top_k_lower_first(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    # Switch-style load-balance loss: E * sum_e f_e * P_e, f_e the
    # dispatch fraction (an integer count over T, exact as the reference's)
    T = x_flat.shape[0]
    counts = torch.zeros(m.num_experts, dtype=torch.int64,
                         device=idx.device).scatter_add_(
        0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    f = counts.float() / T
    aux = m.num_experts * torch.sum(f * probs.mean(0))
    return gates, idx, aux


def capacity(T: int, m: MoEConfig) -> int:
    """Rows an expert takes in the dense path ("generous: no drops")."""
    return max(1, -(-T * m.top_k // m.num_experts) * 4)


def dispatch(gates, idx, num_experts: int, cap: int):
    """Each expert's first ``cap`` selected tokens in token order.

    Returns (tok (E, cap) token indices, T where an expert has fewer;
    wgt (E, cap) their gates, 0 there; slot (T, E) the row e·cap + rank
    of each kept (token, expert) pair in the expert pass, E·cap where the
    token did not pick the expert or the expert dropped it)."""
    T = idx.shape[0]
    dev = idx.device
    w = torch.zeros((T, num_experts), dtype=gates.dtype,
                    device=dev).scatter_(1, idx, gates)
    sel = w > 0
    rank = torch.cumsum(sel, dim=0) - 1                        # (T, E)
    keep = sel & (rank < cap)
    base = torch.arange(num_experts, device=dev) * cap
    slot = torch.where(keep, base + rank, num_experts * cap)
    n = num_experts * cap
    rows = torch.arange(T, device=dev)[:, None].expand(T, num_experts)
    # the dropped pairs all land on the spare entry n, which is cut off
    tok = torch.full((n + 1,), T, dtype=torch.int64, device=dev).scatter_(
        0, slot.reshape(-1), rows.reshape(-1))[:n]
    wgt = torch.zeros((n + 1,), dtype=w.dtype, device=dev).scatter_(
        0, slot.reshape(-1), w.reshape(-1))[:n]
    return (tok.view(num_experts, cap), wgt.view(num_experts, cap), slot)


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


def local_expert_pass(params: MoE, cfg: ModelConfig, x_flat, cap: int,
                      gates, idx):
    """Gather → FFN → combine for all experts: (T, d) in x's dtype."""
    m = cfg.moe
    T, d = x_flat.shape
    E = m.num_experts
    tok, wgt, slot = dispatch(gates, idx, E, cap)
    # Pad x with a zero row; the fill index T points at it.
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    y = expert_ffn(x_pad[tok], params.experts_up, params.experts_down,
                   params.experts_gate, cfg.mlp_act)
    y = y * wgt[..., None].to(y.dtype)
    # each token's rows in ascending expert order; the spare row adds 0
    y_pad = torch.cat([y.reshape(E * cap, d), y.new_zeros((1, d))])
    rows = slot.gather(1, torch.sort(idx, dim=-1).values)      # (T, k)
    out = y_pad[rows[:, 0]]
    for j in range(1, m.top_k):
        out = out + y_pad[rows[:, j]]
    return out


def moe_dense(params: MoE, cfg: ModelConfig, x):
    """Single-device path (all experts local).  Returns (out, aux)."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    gates, idx, aux = route(params.w_router, x_flat, cfg.moe)
    out = local_expert_pass(params, cfg, x_flat,
                            capacity(B * S, cfg.moe), gates, idx)
    return out.reshape(B, S, d), aux


def moe_apply(params: MoE, cfg: ModelConfig, x, par: Parallel = Parallel()):
    """The reference's dispatch; on one device always the dense path.
    Returns (out, aux_loss)."""
    del par
    return moe_dense(params, cfg, x)
