"""Public wrapper, (B, S, H, hd) layout: a CUDA kernel for CUDA tensors,
the plain version (``ref.py``) for CPU tensors, in every mode (causal,
sliding window, logit softcap, GQA, non-causal).  On the card a call goes
to the first kernel whose route takes it: the short-sequence kernel
(``kernel.short_seq_route``: Sq, Sk <= 32, hd <= 64, fp32 or bf16; the
DiT's attention), the tensor-core kernel (``kernel.tensor_core_route``:
bf16; gemma2's prefill), else the CUDA-core kernel.  v (and so o) may have
a head dim hd_v below q's and k's: on the CPU at any hd_v <= hd, on the
card only in the tensor-core kernel's (192, 128) class (latent attention's
heads, ``kernel.split_head_dims``), v read as it is; anything else raises.
``flash_attention.launches`` counts every launch, and
``launches_short``, ``launches_tensor_core`` and ``launches_cuda_core``
each route's (safe to read while threads launch: ``build.count_launch``).
Under an enabled current tracer (``obs/trace.py``) every call, on either
route, is a ``flash_attention`` span carrying the call's shapes:
``B, Sq, Sk, Hq, Hkv, hd, causal, dtype, itemsize``, and ``hd_v`` where
v's head dim is not q's."""
from __future__ import annotations

from repro_torch.kernels.build import check_cuda_inputs, count_launch
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref
from repro_torch.obs.trace import current


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, Sq, Hq, hd), k: (B, Sk, Hkv, hd), v: (B, Sk, Hkv, hd_v) with
    hd_v <= hd → (B, Sq, Hq, hd_v)."""
    tr = current()
    if not tr.enabled:
        return _attention(q, k, v, causal, window, softcap)
    B, Sq, Hq, hd = q.shape
    split = {"hd_v": v.shape[3]} if v.shape[3] != hd else {}
    with tr.span("flash_attention", B=B, Sq=Sq, Sk=k.shape[1], Hq=Hq,
                 Hkv=k.shape[2], hd=hd, causal=bool(causal),
                 dtype=str(q.dtype)[6:], itemsize=q.element_size(), **split):
        return _attention(q, k, v, causal, window, softcap)


def _attention(q, k, v, causal, window, softcap):
    if q.device.type == "cpu":
        out = ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2)
    check_cuda_inputs("flash_attention", q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, Sk, Hkv, hd) or v.shape[:3] != k.shape[:3] \
            or not 1 <= hdv <= hd:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not agree")
    if q.dtype not in K.DTYPES:
        raise NotImplementedError(f"flash_attention on CUDA: {q.dtype}; "
                                  "fp32 and bf16 only")
    if not 1 <= hd <= K.MAX_HEAD_DIM or min(Sq, Sk, B, Hq, Hkv) < 1 \
            or max(B, Hq) > 65535:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}"
                         f" / {tuple(k.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window}, softcap "
                         f"{softcap}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the kernel needs unit stride over hd")
    if hdv != hd and not K.tensor_core_route(q, k, v):
        raise ValueError(f"flash_attention: v's head dim {hdv} against q's "
                         f"{hd} takes only the tensor-core kernel's (192, "
                         f"128) class, in bf16 at strides TMA can address")
    if K.short_seq_route(q, k, v):
        out = K.flash_attention_short_bshd(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
        route = "launches_short"
    elif K.tensor_core_route(q, k, v):
        out = K.flash_attention_tc_bshd(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
        route = "launches_tensor_core"
    else:
        out = K.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        route = "launches_cuda_core"
    count_launch(flash_attention, "launches", route)
    return out


flash_attention.launches = 0
flash_attention.launches_short = 0
flash_attention.launches_tensor_core = 0
flash_attention.launches_cuda_core = 0
