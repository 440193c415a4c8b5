"""FLOP and byte accounting of a step, roofline terms on an H100, and the
structural cost model of one DiT call: the counterpart of the JAX
package's ``launch/hlo_analysis.py`` (the name kept so a reader finds it).

The port has no HLO.  The reference parses XLA's optimised HLO text; here
``count_step(fn, *args)`` runs the step under a ``TorchDispatchMode`` and
counts every aten op it dispatches, forward and backward (on the meta
device nothing is computed, so a full-size step is counted in seconds).
The accounting model is the reference's:

* FLOPs — the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions): 2·|result|·(contracted size), i.e. 2·M·N·K; reductions:
  |operand|; softmax and log-softmax: their decomposition, two reductions
  and three elementwise passes, 5·|operand|; other float elementwise ops:
  |result|; data movement (views, copies, casts, concatenation, gathers,
  scatters, sorts, fills): 0.
* Bytes — each op's result plus its operands.  Views move nothing and
  count 0; a gather reads only its rows (2·|result|), a scatter
  read-modify-writes only its update (2·|source|).  Every op is counted
  apart (eager PyTorch fuses nothing), so the bytes are an upper bound on
  what a fused program moves.
* Collectives — none: the port's mesh is single-controller (one process
  loops over the shards; ``moe_ep``'s combine is an add on the first
  shard's device), so the collective bytes and counts are 0.

``roofline_terms`` divides per-device quantities by an H100 SXM's rates
(the data sheet's dense bf16 peak, its HBM3 rate, and NVLink 4's 18 links
of 25 GB/s a direction), the reference's v5e constants replaced.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

# NVIDIA H100 SXM (data sheet, dense rates, 700 W)
PEAK_FLOPS = 989e12       # bf16 FLOP/s per card
HBM_BW = 3.35e12          # bytes/s per card
NVLINK_BW = 25e9          # bytes/s per link, one direction
NVLINK_LINKS = 18         # NVLink 4 links per card

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution",
           "_convolution", "convolution_backward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "cumsum", "cumprod", "logsumexp", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
               "argmax", "argmin", "any", "all", "_foreach_norm"}
_SOFTMAX = {"_softmax", "_log_softmax"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
_SCATTERS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_put", "index_put_", "index_add", "index_add_",
             "index_copy", "index_copy_", "slice_scatter", "select_scatter",
             "embedding_dense_backward"}
_DATA_MOVEMENT = _GATHERS | _SCATTERS | {
    "clone", "copy", "copy_", "_to_copy", "to", "_copy_from", "_unsafe_view",
    "_copy_from_and_resize", "contiguous", "cat", "stack", "constant_pad_nd",
    "pad", "repeat", "repeat_interleave", "flip", "roll", "tril", "triu",
    "sort", "topk", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill",
    "fill_", "zero_", "arange", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "detach", "alias", "resize_", "set_",
    "scalar_tensor", "masked_fill", "masked_fill_", "where"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Cost:
    """What ``count_step`` counted (global: the whole step, every shard):
    ``flops``, ``bytes``, the op count, FLOPs by op, and the collective
    fields the reference's record has (0 here: ``note`` says why)."""
    flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    flops_by_op: dict = field(default_factory=lambda: defaultdict(float))
    collective_bytes: float = 0.0
    coll_bytes_by_kind: dict = field(default_factory=dict)
    coll_count_by_kind: dict = field(default_factory=dict)
    note: str = ("no collectives: the single-controller mesh loops over "
                 "its shards in one process")

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.ops += 1
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_op[name] += flops


def _charge(name: str, func, args, ins, outs) -> tuple:
    """(FLOPs, bytes) of one op under the accounting model."""
    flops = _flops(name, func, args, ins, outs)
    if func.is_view:
        return flops, 0
    if name in _GATHERS:
        return flops, 2 * sum(_nbytes(t) for t in outs)
    if name in _SCATTERS:
        return flops, 2 * (_nbytes(ins[-1]) if ins else 0)
    return flops, sum(_nbytes(t) for t in ins + outs)


def _flops(name: str, func, args, ins, outs) -> float:
    if not outs or not outs[0].is_floating_point():
        return 0.0
    res = outs[0]
    if name in _MATMUL:
        if "convolution" in name:
            w = args[2] if name == "convolution_backward" else args[1]
            k = w.numel() // w.shape[0]          # (Cin / groups) · kernel
            return 2.0 * sum(t.numel() for t in outs) * k
        a = args[1] if name in ("addmm", "baddbmm", "addbmm") else args[0]
        return 2.0 * res.numel() * a.shape[-1]
    if name in _REDUCTIONS:
        return float(ins[0].numel()) if ins else 0.0
    if name in _SOFTMAX:
        return 5.0 * ins[0].numel()
    if name in _DATA_MOVEMENT or func.is_view:
        return 0.0
    return float(sum(t.numel() for t in outs if t.is_floating_point()))


class _NotMeta(Exception):
    pass


def _meta_key(x):
    """A hashable key of an op's arguments: each tensor by its shape,
    strides, offset and dtype; raises ``_NotMeta`` for a tensor off the
    meta device, ``TypeError`` for an unhashable argument."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    hash(x)
    return x


class _Counting(TorchDispatchMode):
    """Counts each dispatched op.  On the meta device an op that writes
    none of its arguments and returns new tensors has outputs whose shapes
    and strides follow from its arguments' alone: the first call of each
    (op, argument metadata) runs the op's meta function and the repeats
    (a loop over time, the shards of a mesh, the layers) make empty meta
    tensors of the same metadata, with the same charge: the same counts,
    without PyTorch's Python meta functions on every call."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.memo = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference mode composite ops (linear, einsum, matmul) reach
        # the mode whole: count the ops they decompose into
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        name = func.overloadpacket.__name__
        key = self._key(func, args, kwargs)
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            spec, metas, charge = hit
            self.cost.add(name, *charge)
            return tree_unflatten([torch.empty_strided(
                m[0], m[1], dtype=m[2], device="meta") if isinstance(m, tuple)
                else m for m in metas], spec)
        out = func(*args, **kwargs)
        flat, spec = tree_flatten(out)
        outs = [t for t in flat if isinstance(t, torch.Tensor)]
        charge = _charge(name, func, args, _tensors((args, kwargs)), outs)
        self.cost.add(name, *charge)
        if key is not None:
            self.memo[key] = (spec, [
                (tuple(t.shape), t.stride(), t.dtype)
                if isinstance(t, torch.Tensor) else t for t in flat], charge)
        return out

    @staticmethod
    def _key(func, args, kwargs):
        schema = func._schema
        if schema.is_mutable or func.is_view or any(
                r.alias_info is not None for r in schema.returns):
            return None
        try:
            return func, _meta_key(args), _meta_key(kwargs)
        except (_NotMeta, TypeError):
            return None


def count_step(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` and count the FLOPs and bytes of every
    aten op it dispatches (a backward inside ``fn`` included), under the
    accounting model above.  Returns the ``Cost``."""
    cost = Cost()
    with _Counting(cost):
        fn(*args, **kwargs)
    cost.flops_by_op = dict(cost.flops_by_op)
    return cost


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """Three roofline terms in seconds on one H100 SXM (per-device
    quantities)."""
    return {
        "t_compute": flops_per_dev / PEAK_FLOPS,
        "t_memory": bytes_per_dev / HBM_BW,
        "t_collective": coll_bytes_per_dev / (NVLINK_BW * NVLINK_LINKS),
    }


def dominant_term(terms: dict) -> str:
    key = max(("t_compute", "t_memory", "t_collective"), key=lambda k: terms[k])
    return {"t_compute": "compute", "t_memory": "memory",
            "t_collective": "collective"}[key]


# ---------------------------------------------------------------------------
# structural denoiser roofline (fused vs naive dit_apply)
# ---------------------------------------------------------------------------

def denoiser_cost(dc, batch: int, image_size: int, channels: int = 3, *,
                  fused: bool = False, bf16: bool = False) -> dict:
    """Structural FLOP/byte model of ONE ``dit_apply`` call, the
    reference's arithmetic.

    Counts the documented dominant terms — matmul traffic, attention
    traffic, and the LN+modulation sites — for the plain denoiser vs the
    kernel one (kernels/flash_attention + kernels/adaln_norm).  FLOPs are
    identical across the two (fusion changes WHERE intermediates live, not
    the arithmetic); bytes differ:

    * attention — plain materialises the (B, h, S, S) logits and probs in
      HBM (logits write + softmax read/write + prob read for the PV
      matmul = 4 S² passes, fp32); the kernel streams K/V blocks through
      on-chip memory with online softmax, so only q/k/v reads and the o
      write remain;
    * LN sites — plain takes ~3 HBM passes over the (B, S, d) tokens per
      site (stats read, normalise read, modulated write); the kernel
      takes 2 (read + write);
    * ``bf16`` halves the QKV/MLP matmul operand traffic (activations and
      weights move as bf16; accumulation stays fp32).

    Residual adds, patchify/unpatchify reshapes and the tiny conditioning
    MLP are identical on both paths and omitted.  Returns
    ``{"flops", "bytes", "intensity"}`` (global, one call).
    """
    B, d, L = batch, dc.d_model, dc.num_layers
    h, p = dc.num_heads, dc.patch
    n_tok = (image_size // p) ** 2
    S = n_tok + 1
    pd = p * p * channels
    ff = 4 * d
    f32 = 4
    act = 2 if (fused and bf16) else 4

    # -- FLOPs (2·M·N·K per matmul; same fused or naive) --
    flops = 2.0 * B * n_tok * pd * d                  # patch_in
    flops += 2.0 * B * (2 * d * d + 2 * dc.cond_dim * d)  # cond MLP + y maps
    per_layer = (2.0 * B * d * 6 * d                  # adaLN modulation
                 + 2.0 * B * S * d * 3 * d            # qkv
                 + 2.0 * 2 * B * S * S * d            # qk^T + pv
                 + 2.0 * B * S * d * d                # wo
                 + 2.0 * 2 * B * S * d * ff)          # mlp up + down
    flops += L * per_layer
    flops += 2.0 * B * d * 2 * d + 2.0 * B * n_tok * d * pd  # out head

    # -- HBM bytes --
    tok = B * S * d                                   # one token tensor
    # matmul operand/result traffic (per layer)
    mm = ((tok + 3 * d * d + 3 * tok)                 # qkv
          + (tok + d * d + tok)                       # wo
          + (tok + 4 * d * d + 4 * tok)               # mlp up
          + (4 * tok + 4 * d * d + tok)) * act        # mlp down
    mm += (B * d + 6 * d * d + 6 * B * d) * f32       # modulation (fp32)
    # attention traffic
    attn_io = (3 * tok + tok) * f32                   # q/k/v read + o write
    s2 = B * h * S * S * f32
    attn = attn_io + (0 if fused else 4 * s2)
    # LN+modulation sites: 2 per layer (+1 final, counted below)
    ln_passes = 2 if fused else 3
    ln = 2 * ln_passes * tok * f32
    bytes_ = L * (mm + attn + ln)
    bytes_ += ln_passes * B * n_tok * d * f32         # final LN site
    bytes_ += (B * n_tok * pd + pd * d + B * n_tok * d) * f32   # patch_in
    bytes_ += (B * n_tok * d + d * pd + B * n_tok * pd) * f32   # patch_out
    return {"flops": flops, "bytes": float(bytes_),
            "intensity": flops / bytes_}
