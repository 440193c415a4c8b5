"""Public wrapper for the fused adaLN LayerNorm: the CUDA kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

from repro_torch.kernels.adaln_norm import kernel as K
from repro_torch.kernels.adaln_norm import ref
from repro_torch.kernels.build import check_cuda_inputs, count_launch


def adaln_norm(x, scale, shift, eps: float = 1e-6):
    """x: (B, N, d) tokens; scale/shift: (B, d) per-batch-row modulation."""
    if x.device.type == "cpu":
        return ref.adaln_norm(x, scale, shift, eps)
    check_cuda_inputs("adaln_norm", x, scale, shift)
    B, N, d = x.shape
    if scale.shape != (B, d) or shift.shape != (B, d):
        raise ValueError(f"adaln_norm: scale/shift must be {(B, d)}, got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")
    if x.dtype not in K.DTYPES:
        raise NotImplementedError(f"adaln_norm on CUDA: {x.dtype}; fp32 and "
                                  "bf16 only")
    if not 1 <= d <= K.MAX_D or B * N < 1:
        raise ValueError(f"adaln_norm: unsupported shape {tuple(x.shape)} "
                         f"(d <= {K.MAX_D})")
    sx = x.stride()
    if sx[2] != 1 or scale.stride(1) != 1 or shift.stride(1) != 1:
        raise ValueError("adaln_norm: the kernel needs unit stride over d")
    if max(sx[0] * B, B * N * d) >= 2 ** 31:
        raise ValueError("adaln_norm: offsets beyond 2**31 elements")
    out = K.adaln_norm_3d(x, scale, shift, eps)
    count_launch(adaln_norm, "launches")
    return out


adaln_norm.launches = 0
