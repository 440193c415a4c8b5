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


def lm_state_from_jax(params, cfg) -> dict:
    """``init_lm(key, cfg)`` tree (the reference's, or the port's
    ``init_lm_tree``) → ``LM.load_state_dict`` input.

    ``params["groups"]`` holds ``p0..p{period-1}``, each stacked along a
    leading ``num_groups`` axis; absolute layer ``g · period + p`` takes
    slice g of ``p{p}``.  Dense ``w`` (and the MLP's bare ``w_up``,
    ``w_gate``, ``w_down``) is (in, out) there and (out, in) in
    ``nn.Linear``; norms carry ``scale`` in both."""
    def tensor(a):
        # a tree of torch tensors (``init_lm_tree``'s, on any device) stays
        # where it is; arrays cross over as float32
        if isinstance(a, torch.Tensor):
            return a.float()
        return torch.tensor(np.asarray(a, np.float32))

    state = {"embedding": tensor(params["embed"]["embedding"])}

    def walk(prefix: str, node, g=None) -> None:
        def leaf(a):
            a = tensor(a)
            return a if g is None else a[g]
        if not isinstance(node, dict):     # the MLP's bare (in, out) matrices
            state[f"{prefix}weight"] = leaf(node).T.contiguous()
        elif "w" in node:
            state[f"{prefix}weight"] = leaf(node["w"]).T.contiguous()
            if "b" in node:
                state[f"{prefix}bias"] = leaf(node["b"])
        elif "scale" in node:
            state[f"{prefix}scale"] = leaf(node["scale"])
        else:
            for k, v in node.items():
                walk(f"{prefix}{k}.", v, g)

    walk("final_norm.", params["final_norm"])
    if "lm_head" in params:
        walk("lm_head.", params["lm_head"])
    for g in range(cfg.num_groups):
        for p in range(cfg.period):
            walk(f"layers.{g * cfg.period + p}.", params["groups"][f"p{p}"], g)
    return state
