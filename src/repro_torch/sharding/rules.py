"""The row-window layout of a placed synthesis wave, from the JAX
package's ``sharding/rules.py``.

A mesh's ``model`` axis is tensor-parallel and every other axis but a
serving mesh's ``hosts`` is batch-parallel (``MeshAxes``).  A spec names,
per dimension of an operand, the mesh axes that dimension is split over,
or None where it is whole: the reference's ``PartitionSpec``, kept here as
a plain tuple.

The placed path needs one rule, ``wave_window_specs``: a host window's
row operands (its conditioning rows, row keys, classifier ids and labels,
and the x / ε / noise rows) split by rows over the host submesh's data
axes, while the wave-resident scalar table, the guidance vector and the
mode vector are replicated, read through the cfg kernel's ``row_offset``.
The ``model`` axis does no window work: the DiT's weights replicate and a
window's rows do not depend on each other, so a window chunk runs once,
on the first device of its model group (``launch/mesh.py::
data_devices``).

The LM zoo's layout, the reference's partition rules:

* ``model`` — tensor parallel: attention heads, FFN hidden, experts,
  vocab;
* the data axes — batch parallel; parameters are also split over them on
  their non-model dim (FSDP/ZeRO-style);
* norm scales and other small vectors are replicated.

Rules match on the reference's leaf paths (``groups/p0/mixer/wq/w``).  A
leaf of the port's ``LM`` resolves its rule on the reference path that
``convert.lm_state_items`` pairs it with; then a transposed weight
(``nn.Linear``'s (out, in), the reference's (in, out)) swaps its two
entries, and a layer leaf drops the reference's leading ``num_groups``
entry (the port's layers are not stacked).  ``param_specs``,
``batch_specs`` and ``cache_specs`` return specs as plain tuples in trees
of the port's shapes; ``to_shardings`` makes ``launch/mesh.py``
``NamedSharding``s of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshAxes:
    data: tuple            # ("pod", "data") or ("data",)
    model: str             # "model"

    @property
    def all_data(self):
        return self.data if len(self.data) > 1 else self.data[0]


def wave_window_specs(ax: MeshAxes) -> dict:
    """Specs for one host window of a placed synthesis wave: the window's
    image-shaped tensors (x / ε / noise, batch-leading 4-D), its
    conditioning rows, row keys, classifier ids and labels split their
    rows over the host's data axes (a window is rounded to the data size,
    so the split is even); the wave-resident (·, B_wave) scalar table, the
    wave-wide guidance and mode vectors are replicated."""
    D = ax.all_data
    return {
        "window": (D, None, None, None),    # x / eps_c / eps_u / noise
        "cond": (D, None),                  # window conditioning rows
        "row_keys": (D,),                   # per-row noise keys
        "scalar_table": (None, None),       # wave-resident (·, B_wave)
        "guidance": (None,),                # wave-wide (B_wave,)
        "mode": (None,),                    # wave-wide (B_wave,) modes
        "clf_ids": (D,),                    # window-local classifier slots
        "labels": (D,),                     # window-local classifier targets
    }


def splits_rows(spec: tuple) -> bool:
    """Whether an operand of this spec is split by rows (its first
    dimension names mesh axes) rather than replicated."""
    return bool(spec) and spec[0] is not None


# (path-suffix, spec) rules; first match wins.  Specs are for the
# *unstacked* reference leaf; a leading None is prepended for a scan group.
def _rules(ax: MeshAxes):
    D, M = ax.all_data, ax.model
    return [
        ("embed/embedding", (M, D)),
        ("lm_head/w", (D, M)),
        ("enc_head/w", (D, M)),
        ("frontend_proj/w", (None, M)),
        ("mask_embed", ()),
        # attention + mlstm projections
        ("wq/w", (D, M)), ("wk/w", (D, M)), ("wv/w", (D, M)),
        ("wq/b", (M,)), ("wk/b", (M,)), ("wv/b", (M,)),
        ("wo/w", (M, D)),
        # mlp
        ("w_up/w", (D, M)), ("w_gate/w", (D, M)), ("w_down/w", (M, D)),
        ("mlp/w_up", (D, M)), ("mlp/w_gate", (D, M)), ("mlp/w_down", (M, D)),
        # moe
        ("w_router", (D, None)),
        ("experts_up", (M, D, None)),
        ("experts_gate", (M, D, None)),
        ("experts_down", (M, None, D)),
        # mamba
        ("in_proj/w", (D, M)),
        ("conv_w", (None, M)), ("conv_b", (M,)),
        ("x_proj/w", (M, None)),
        ("dt_proj/w", (None, M)), ("dt_proj/b", (M,)),
        ("A_log", (M, None)), ("D", (M,)),
        ("out_proj/w", (M, D)),
        # xlstm
        ("w_igate/w", (D, None)), ("w_igate/b", ()),
        ("w_fgate/w", (D, None)), ("w_fgate/b", ()),
        ("w_x/w", (D, M)), ("w_r", ()),
        ("up_proj/w", (D, M)), ("down_proj/w", (M, D)),
        # norms / scalars (must come after the specific rules)
        ("scale", ()), ("bias", ()), ("/b", ()),
    ]


def _serve2d_rules(ax: MeshAxes):
    """Serving layout: weights split on their OUTPUT dim over the combined
    (data × model) device set.  MoE expert slabs keep the train layout
    (``moe_ep`` pins experts to the model axis)."""
    D, M = ax.all_data, ax.model
    DM = (tuple(ax.data) + (M,)) if isinstance(D, tuple) else (D, M)
    return [
        ("embed/embedding", (DM, None)),
        ("lm_head/w", (None, DM)),
        ("enc_head/w", (None, DM)),
        ("wq/w", (None, DM)), ("wk/w", (None, DM)), ("wv/w", (None, DM)),
        ("wq/b", (DM,)), ("wk/b", (DM,)), ("wv/b", (DM,)),
        ("wo/w", (DM, None)),
        ("mlp/w_up", (None, DM)), ("mlp/w_gate", (None, DM)),
        ("mlp/w_down", (DM, None)),
        ("in_proj/w", (None, DM)),
        ("conv_w", (None, DM)), ("conv_b", (DM,)),
        ("x_proj/w", (DM, None)),
        ("dt_proj/w", (None, DM)), ("dt_proj/b", (DM,)),
        ("A_log", (DM, None)), ("D", (DM,)),
        ("out_proj/w", (DM, None)),
        ("w_x/w", (None, DM)),
        ("up_proj/w", (None, DM)), ("down_proj/w", (DM, None)),
    ]


def _shard_count(entry, ax: MeshAxes) -> int:
    """Devices an entry splits over on the production mesh (16 × 16, two
    pods), as the reference reckons them."""
    if entry is None:
        return 1
    sizes = {"model": 16, "data": 16, "pod": 2}
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes.get(n, 1) for n in names)


def _spec_for(path: str, shape, ax: MeshAxes, mode: str = "train") -> tuple:
    """The reference's spec of its leaf at ``path`` of ``shape`` (stacked
    leaves, under ``groups/``, lead with ``num_groups``)."""
    ndim = len(shape)
    stacked = path.startswith("groups/")
    base_ndim = ndim - 1 if stacked else ndim
    base_shape = shape[1:] if stacked else shape

    def resolve(rules):
        for suffix, spec in rules:
            if path.endswith(suffix):
                s = tuple(spec)
                if len(s) < base_ndim:
                    s = s + (None,) * (base_ndim - len(s))
                return s[:base_ndim]
        return None

    spec = None
    if mode == "serve2d":
        s = resolve(_serve2d_rules(ax))
        if s is not None and all(
                dim % _shard_count(e, ax) == 0
                for dim, e in zip(base_shape, s)):
            spec = s
    if spec is None:
        spec = resolve(_rules(ax)) or ()
    if mode == "serve1d":
        # serving: drop the FSDP (data-axis) factors; weights live split
        # over `model` only, so decode never gathers parameters
        def strip(e):
            if e is None:
                return None
            names = e if isinstance(e, tuple) else (e,)
            kept = tuple(n for n in names if n == ax.model)
            return kept[0] if len(kept) == 1 else (kept or None)
        spec = tuple(strip(e) for e in spec)
    if stacked:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def leaf_paths(cfg) -> dict:
    """Every leaf of the port's ``LM`` for ``cfg``: state name → (the
    reference's path, whether the port's leaf is its transpose, whether the
    reference stacks it over groups)."""
    from repro_torch.convert import lm_state_items
    from repro_torch.models.transformer import skeleton
    return {name: (load.leaf, load.transpose, load.group is not None)
            for name, load in lm_state_items(skeleton(cfg), cfg)}


def param_specs(lm, ax: MeshAxes, mode: str = "train") -> dict:
    """Specs of the port's ``LM`` (a module, meta or real), by state name.

    mode="train": TP over the model axis + FSDP over the data axes;
    "serve1d": the model axis only; "serve2d": output-dim splits over all
    devices where they divide, else the train rule."""
    paths = leaf_paths(lm.cfg)
    specs = {}
    for name, t in lm.state_dict().items():
        path, transposed, stacked = paths[name]
        shape = tuple(t.shape[::-1]) if transposed else tuple(t.shape)
        spec = _spec_for(path, ((1,) if stacked else ()) + shape, ax, mode)
        spec = spec[1:] if stacked else spec
        specs[name] = spec[::-1] if transposed and len(spec) == 2 else spec
    return specs


def batch_specs(cfg, shape, ax: MeshAxes, batch_sharded: bool) -> dict:
    """Specs for the input batch of a train/prefill step."""
    bdim = ax.all_data if batch_sharded else None
    if cfg.frontend == "token":
        return {"tokens": (bdim, None)}
    if cfg.frontend == "vision_patches":
        return {"patches": (bdim, None, None), "tokens": (bdim, None)}
    if cfg.frontend == "audio_frames":
        return {"frames": (bdim, None, None), "mask": (bdim, None),
                "labels": (bdim, None)}
    raise ValueError(cfg.frontend)


def cache_specs(cfg, shape, ax: MeshAxes, batch_sharded: bool,
                caches) -> list:
    """Specs of the decode caches, one per layer as ``LM.init_caches``
    gives them (the reference's stacked specs without the group entry).

    * batch shardable (decode_32k): batch → data axes, KV seq → model.
    * batch=1 (long_500k): KV seq → (data, model), context parallel;
      recurrent-state channel dims → model."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaState
    from repro_torch.models.xlstm import MLSTMState, SLSTMState

    D, M = ax.all_data, ax.model
    bdim = D if batch_sharded else None
    seq_dims = M if batch_sharded else (D, M) if isinstance(D, str) else (
        *ax.data, M)

    def spec_tree(cache):
        if isinstance(cache, KVCache):
            s = (bdim, seq_dims, None, None)
            return KVCache(s, s)
        if isinstance(cache, MambaState):
            return MambaState((bdim, M, None), (bdim, None, M))
        if isinstance(cache, MLSTMState):
            return MLSTMState((bdim, None, None, None), (bdim, None, None),
                              (bdim, None), (bdim, None, M))
        if isinstance(cache, SLSTMState):
            s = (bdim, None)
            return SLSTMState(s, s, s, s)
        raise TypeError(type(cache))

    return [spec_tree(c) for c in caches]


def is_spec(x) -> bool:
    """A spec is a plain tuple (a NamedTuple of specs is a tree)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def tree_map_specs(fn, tree):
    """``fn`` on every spec of a tree of dicts, lists and NamedTuples."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):                 # a NamedTuple
        return type(tree)(*(tree_map_specs(fn, v) for v in tree))
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(type(tree))


def to_shardings(spec_tree, mesh):
    """The tree with each spec a ``launch/mesh.py::NamedSharding`` on
    ``mesh``."""
    from repro_torch.launch.mesh import NamedSharding
    return tree_map_specs(lambda s: NamedSharding(mesh, s), spec_tree)
