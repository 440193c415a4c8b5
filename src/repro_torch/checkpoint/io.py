"""Checkpoints: a tree of arrays ↔ ``.npz`` plus a JSON manifest, in the
JAX package's format (``checkpoint/io.py``), so a checkpoint written by
either package loads into the other.

A tree is nested dicts and lists (tuples) whose leaves are tensors, numpy
arrays or numbers.  Flat keys are the reference's ``tree_paths`` strings
(``a/b/0/c``) in jax's flatten order: dict keys sorted, lists by index.
The manifest lists the keys, each leaf's dtype (``dtypes``) and a ``meta``
map.  Dtypes numpy's npz format cannot hold (bfloat16, float8) are stored
as raw bits in a same-width unsigned integer array and viewed back on
load through torch, so no numpy extension dtype is needed.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

# numpy's own format holds these; the rest go through the raw-bits path
_NATIVE_KINDS = frozenset("biufc")
_EXTENSION = {"bfloat16": torch.bfloat16,
              "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
_SIGNED = {1: torch.int8, 2: torch.int16}   # torch views these, not uint


def tree_paths(tree) -> list:
    """(``"a/b/0/c"``, leaf) pairs in jax's flatten order; ``None`` is an
    empty subtree, as in jax."""
    out = []

    def walk(prefix, node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [str(i)], v)
        else:
            out.append(("/".join(prefix), node))

    walk([], tree)
    return out


def _stored(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, array numpy can store) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = str(leaf.dtype).removeprefix("torch.")
        if name in _EXTENSION:
            width = leaf.element_size()
            return name, leaf.view(_SIGNED[width]).numpy().view(f"u{width}")
        return name, leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.kind in _NATIVE_KINDS:
        return str(a.dtype), a
    return str(a.dtype), a.view(np.dtype(f"u{a.dtype.itemsize}"))


def save_pytree(tree, path: str | Path, meta: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = tree_paths(tree)
    arrays, dtypes = {}, {}
    for p, leaf in flat:
        dtypes[p], arrays[p] = _stored(leaf)
    np.savez(path.with_suffix(".npz"), **arrays)
    manifest = {"keys": [p for p, _ in flat], "dtypes": dtypes,
                "meta": meta or {}}
    path.with_suffix(".json").write_text(json.dumps(manifest, indent=1))


def _restored(p: str, arr: np.ndarray, want: str | None) -> torch.Tensor:
    """The npz array ``arr`` as a CPU tensor of the manifest's dtype."""
    if want is None:                  # a manifest from before dtypes
        return torch.from_numpy(arr)
    if want in _EXTENSION:
        width = _EXTENSION[want].itemsize
        if arr.dtype == np.dtype(f"u{width}"):
            return torch.from_numpy(arr.view(f"i{width}")).view(
                _EXTENSION[want])
    elif arr.dtype.kind in _NATIVE_KINDS and arr.dtype == np.dtype(want):
        return torch.from_numpy(arr)
    raise ValueError(f"{p}: npz dtype {arr.dtype} inconsistent with "
                     f"manifest dtype {want}")


def load_pytree(template, path: str | Path):
    """Restore into the structure of ``template`` (nested dicts and lists
    whose leaves have a ``shape``): CPU tensors of the SAVED dtype, as the
    manifest records it (a bf16 checkpoint restores as bf16 into an fp32
    template); a checkpoint from before dtypes were recorded restores with
    the dtype its npz holds."""
    path = Path(path)
    manifest = json.loads(path.with_suffix(".json").read_text())
    dtypes = manifest.get("dtypes", {})
    with np.load(path.with_suffix(".npz"), allow_pickle=False) as data:
        restored = {}
        for p, leaf in tree_paths(template):
            if p not in data:
                raise KeyError(f"checkpoint missing key {p}")
            arr = data[p]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{p}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            restored[p] = _restored(p, arr, dtypes.get(p))

    def rebuild(prefix, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(prefix + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(prefix + [str(i)], v)
                              for i, v in enumerate(node))
        return restored["/".join(prefix)]

    return rebuild([], template)


def exists(path: str | Path) -> bool:
    path = Path(path)
    return (path.with_suffix(".npz").exists()
            and path.with_suffix(".json").exists())
