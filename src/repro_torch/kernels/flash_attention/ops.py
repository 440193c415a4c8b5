"""Public wrapper, (B, S, H, hd) layout: the CUDA kernel for CUDA tensors
(non-causal mode), the plain version (``ref.py``, every mode) for CPU
tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_cuda_inputs
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd) → (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        out = ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    check_cuda_inputs("flash_attention", q, k, v)
    if causal or window or softcap or k.shape[2] != q.shape[2]:
        raise NotImplementedError(
            "flash_attention on CUDA: only the non-causal mode without "
            "window, softcap or GQA is ported")
    B, Sq, H, hd = q.shape
    if k.shape != (B, k.shape[1], H, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not agree")
    if q.dtype != torch.float32:
        raise NotImplementedError("flash_attention on CUDA: fp32 only")
    if not 1 <= hd <= K.MAX_HEAD_DIM or min(Sq, k.shape[1], B, H) < 1 \
            or max(B, H) > 65535:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}"
                         f" / {tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel needs unit stride over hd")
    out = K.flash_attention_bshd(q, k, v)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
