"""Public wrapper for the fused CFG update: the Triton kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.build import check_cuda_inputs
from repro_torch.kernels.cfg_fuse import kernel as K
from repro_torch.kernels.cfg_fuse import ref


def step_scalars(s: float, ab_t, ab_prev, eta: float):
    """(1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir_coef, σ) of one reverse step,
    in float32 with the plain version's operations in its order, so the
    kernel rounds every scalar as ``ref.ancestral_step`` does."""
    f = np.float32
    one, ab_t, ab_prev = f(1), f(ab_t), f(ab_prev)
    var = (one - ab_prev) / (one - ab_t) * (one - ab_t / ab_prev)
    sigma = f(eta) * np.sqrt(np.maximum(var, f(0)))
    dir_coef = np.sqrt(np.maximum(one - ab_prev - sigma * sigma, f(0)))
    return (f(1.0 + s), f(s), np.sqrt(one - ab_t), np.sqrt(ab_t),
            np.sqrt(ab_prev), dir_coef, sigma)


def cfg_update(x, eps_c, eps_u, s: float, ab_t, ab_prev, noise,
               eta: float = 1.0):
    """Fused (1+s)·ε_c − s·ε_u guidance + ancestral update.  x, eps_c,
    eps_u and noise share one arbitrary shape; s, ab_t, ab_prev and eta
    are scalars (host numbers on the CUDA path)."""
    if x.device.type == "cpu":
        return ref.cfg_update(x, eps_c, eps_u, s, ab_t, ab_prev, noise, eta)
    check_cuda_inputs("cfg_update", x, eps_c, eps_u, noise)
    for t in (eps_c, eps_u, noise):
        if t.shape != x.shape:
            raise ValueError(f"cfg_update: shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (x, eps_c, eps_u, noise)):
        raise ValueError("cfg_update: the kernel takes contiguous tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError("cfg_update: more than 2**31 elements")
    out = K.cfg_update_flat(x, eps_c, eps_u, noise,
                            step_scalars(s, ab_t, ab_prev, eta))
    cfg_update.launches += 1
    return out


cfg_update.launches = 0
