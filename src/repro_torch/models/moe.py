"""How the LM runs on the card: the fields of the JAX package's
``models/moe.py::Parallel`` that mean something on one device.

The MoE FFN itself (``moe_apply``) and the mesh and sharding fields come
with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass


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
