"""Parameters of the JAX package's DiT, classifiers and LMs, as the port's
``state_dict``s.

The reference ``init_dit`` pytree is nested dicts of arrays plus a
``blocks`` list; Dense weights there are (in, out), ``nn.Linear`` stores
(out, in).  The tree crosses over as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

_DENSE = ("patch_in", "t_mlp1", "t_mlp2", "y_proj", "out_mod", "patch_out",
          "cond_tok")
_BLOCK_DENSE = ("wqkv", "wo", "w_up", "w_down", "mod")


def _dense(state: dict, name: str, p: dict) -> None:
    state[f"{name}.weight"] = torch.tensor(np.asarray(p["w"], np.float32).T)
    if "b" in p:
        state[f"{name}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))


def dit_state_from_jax(tree) -> dict:
    """``init_dit``-shaped tree → ``DiT.load_state_dict`` input."""
    state = {"pos": torch.tensor(np.asarray(tree["pos"], np.float32)),
             "null_y": torch.tensor(np.asarray(tree["null_y"], np.float32))}
    for name in _DENSE:
        _dense(state, name, tree[name])
    for i, blk in enumerate(tree["blocks"]):
        for name in _BLOCK_DENSE:
            _dense(state, f"blocks.{i}.{name}", blk[name])
    return state


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _dense_node(state: dict, name: str) -> dict:
    node = {"w": _np(state[f"{name}.weight"]).T.copy()}
    if f"{name}.bias" in state:
        node["b"] = _np(state[f"{name}.bias"])
    return node


def dit_tree_from_state(state: dict) -> dict:
    """The inverse of ``dit_state_from_jax``: a ``DiT.state_dict()`` as
    the reference's ``init_dit`` tree of float32 numpy arrays, Dense ``w``
    (in, out), ``blocks`` a list."""
    tree = {"pos": _np(state["pos"]), "null_y": _np(state["null_y"])}
    for name in _DENSE:
        tree[name] = _dense_node(state, name)
    n_blocks = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    tree["blocks"] = [{name: _dense_node(state, f"blocks.{i}.{name}")
                       for name in _BLOCK_DENSE} for i in range(n_blocks)]
    return tree


def classifier_state_from_jax(tree, name: str) -> dict:
    """``init_classifier(key, name, ...)`` tree → the port's module of the
    same ``name`` (``load_state_dict`` input).  Convolutions are HWIO there
    and OIHW here; norms carry (scale, bias) there and (weight, bias) here;
    ``pos`` and ``cls`` cross as they are."""
    from repro_torch.models.classifiers import CLASSIFIERS
    if name not in CLASSIFIERS:
        raise ValueError(name)
    state = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict) and "w" in node:
            w = np.asarray(node["w"], np.float32)
            state[f"{prefix}weight"] = torch.tensor(
                w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T)
            if "b" in node:
                state[f"{prefix}bias"] = torch.tensor(
                    np.asarray(node["b"], np.float32))
        elif isinstance(node, dict) and "scale" in node:
            state[f"{prefix}weight"] = torch.tensor(
                np.asarray(node["scale"], np.float32))
            state[f"{prefix}bias"] = torch.tensor(
                np.asarray(node["bias"], np.float32))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            state[prefix[:-1]] = torch.tensor(np.asarray(node, np.float32))

    walk("", tree)
    return state


class _LeafLoad:
    """A load of one leaf: an array (crossing over as float32), a torch
    tensor (``init_lm_tree``'s, on any device, staying there) or a lazy
    leaf (a call that draws it); slice ``group`` of a group-stacked leaf;
    (in, out) matrices transposed to ``nn.Linear``'s (out, in), as a view.
    Called, it loads; its fields say where the leaf comes from (the
    partition rules read them on a tree of paths)."""

    def __init__(self, leaf, group=None, transpose=False):
        self.leaf, self.group, self.transpose = leaf, group, transpose

    def __call__(self):
        a = self.leaf
        t = a() if callable(a) else a
        t = (t.float() if isinstance(t, torch.Tensor)
             else torch.tensor(np.asarray(t, np.float32)))
        t = t if self.group is None else t[self.group]
        return t.T if self.transpose else t


# The only bare (in, out) matrices of the reference's LM tree: the dense
# MLP's.  Every other bare leaf (the experts, ``w_router``, Mamba's
# ``conv_w``, ``conv_b``, ``A_log`` and ``D``, sLSTM's ``w_r`` and ``b``) is
# a parameter of the same name in the reference's layout.
_MLP_MATRICES = ("w_up", "w_gate", "w_down")


def lm_layer_items(prefix: str, node, g=None):
    """(state name, load) of every leaf of a subtree of the reference's LM
    tree.  Dense ``w`` (and the MLP's bare ``w_up``, ``w_gate``,
    ``w_down``) is (in, out) there and (out, in) in ``nn.Linear``; every
    other bare leaf keeps its name and the reference's layout; norms carry
    ``scale`` in both."""
    if "w" in node:
        yield f"{prefix}weight", _LeafLoad(node["w"], g, True)
        if "b" in node:
            yield f"{prefix}bias", _LeafLoad(node["b"], g)
    elif "scale" in node:
        yield f"{prefix}scale", _LeafLoad(node["scale"], g)
    else:
        for k, v in node.items():
            if isinstance(v, dict):
                yield from lm_layer_items(f"{prefix}{k}.", v, g)
            elif k in _MLP_MATRICES:
                yield f"{prefix}{k}.weight", _LeafLoad(v, g, True)
            else:
                yield f"{prefix}{k}", _LeafLoad(v, g)


def lm_state_items(params, cfg):
    """(state name, load) of every leaf of an ``init_lm``-shaped tree;
    ``params["groups"]``, where present, holds ``p0..p{period-1}``, each
    stacked along a leading ``num_groups`` axis: absolute layer
    ``g · period + p`` takes slice g of ``p{p}``."""
    yield "embedding", _LeafLoad(params["embed"]["embedding"])
    if "frontend_proj" in params:
        yield from lm_layer_items("frontend_proj.", params["frontend_proj"])
    if "mask_embed" in params:
        yield "mask_embed", _LeafLoad(params["mask_embed"])
    yield from lm_layer_items("final_norm.", params["final_norm"])
    for head in ("lm_head", "enc_head"):
        if head in params:
            yield from lm_layer_items(f"{head}.", params[head])
    for g in range(cfg.num_groups if "groups" in params else 0):
        for p in range(cfg.period):
            yield from lm_layer_items(f"layers.{g * cfg.period + p}.",
                                      params["groups"][f"p{p}"], g)


def lm_state_from_jax(params, cfg) -> dict:
    """``init_lm(key, cfg)`` tree (the reference's, or the port's
    ``init_lm_tree``) → ``LM.load_state_dict`` input."""
    return {name: load() for name, load in lm_state_items(params, cfg)}

