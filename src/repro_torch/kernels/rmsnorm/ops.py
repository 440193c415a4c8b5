"""Public wrapper for the fused RMSNorm: the CUDA kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors.

No model code calls it, as in the JAX package, where
``models/layers.rmsnorm`` is plain too."""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_cuda_inputs, count_launch
from repro_torch.kernels.rmsnorm import kernel as K
from repro_torch.kernels.rmsnorm import ref


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d) with any leading dimensions; scale: (d,)."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    check_cuda_inputs("rmsnorm", x)
    check_cuda_inputs("rmsnorm", scale)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale must be {(d,)}, got "
                         f"{tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    if not 1 <= d <= K.MAX_D or x.numel() == 0:
        raise ValueError(f"rmsnorm: unsupported shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or scale.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"rmsnorm on CUDA: {x.dtype} / "
                                  f"{scale.dtype}; fp32 and bf16 only")
    x2 = x.reshape(-1, d)          # a view where the strides allow it
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm: the kernel needs unit stride over d")
    out = K.rmsnorm_2d(x2, scale.contiguous(), eps)
    count_launch(rmsnorm, "launches")
    return out.reshape(x.shape)


rmsnorm.launches = 0
