"""Parameters of the JAX package's DiT, as the port's ``state_dict``.

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
