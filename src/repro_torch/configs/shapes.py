"""Input stand-ins for every (arch × shape) pair, which pairs run, the
arch variant each lowers, and the reduced smoke variants for CPU tests:
the JAX package's ``configs/shapes.py``.

Decode shapes run the decode step: ONE new token against a KV cache /
recurrent state of ``seq_len``.  ``input_specs`` allocates nothing: its
stand-ins are meta tensors (shape and dtype), the caches from
``LM.init_caches`` on the meta device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch × shape) is runnable; else the documented skip reason."""
    if shape.kind in ("decode",) and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.arch_type in ("ssm", "hybrid") or (
            cfg.sliding_window > 0 and all(
                k == "attn_local" for k in cfg.layer_pattern))
        if not sub_quadratic:
            if cfg.name == "gemma2-2b":
                # runs via the registered sliding-window-only variant
                return True, "uses gemma2-2b-swa sliding-window decode variant"
            return False, "full-attention arch at 500k context (documented skip)"
    return True, ""


def resolve_decode_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Arch variant actually lowered for this shape (gemma2 long-context
    decode swaps to the sliding-window-only variant)."""
    if shape.name == "long_500k" and cfg.name == "gemma2-2b":
        from repro_torch.configs.base import get_config
        return get_config("gemma2-2b-swa")
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for the step of ``shape.kind``: ``{"batch"}``
    for train and prefill; ``{"tokens", "caches", "pos"}`` for decode, the
    caches one per layer as ``LM.init_caches`` gives them."""
    B, S = shape.global_batch, shape.seq_len
    adt = cfg.act_dtype
    cfg = resolve_decode_config(cfg, shape)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "token":
            batch = {"tokens": _meta((B, S), torch.int32)}
        elif cfg.frontend == "vision_patches":
            P = cfg.num_prefix_tokens
            batch = {"patches": _meta((B, P, cfg.frontend_dim), adt),
                     "tokens": _meta((B, S - P), torch.int32)}
        elif cfg.frontend == "audio_frames":
            batch = {"frames": _meta((B, S, cfg.frontend_dim), adt),
                     "mask": _meta((B, S), torch.bool),
                     "labels": _meta((B, S), torch.int32)}
        else:
            raise ValueError(cfg.frontend)
        return {"batch": batch}
    if shape.kind == "decode":
        from repro_torch.models.transformer import LM
        caches = LM(cfg, device="meta").init_caches(B, S, adt)
        return {"tokens": _meta((B, 1), torch.int32), "caches": caches,
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family: ≤2 groups, d_model ≤ 512,
    ≤4 experts — runs a real forward/train step on CPU."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    while heads % kv:
        kv += 1
    head_dim = max(d // heads, 32)
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=cfg.period * min(cfg.num_groups, 2),
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 503 if cfg.is_encoder else 512),
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 4) if cfg.num_prefix_tokens else 0,
        dtype="float32",
        remat="none",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 2 * d))
    return cfg.replace(**kw)


def smoke_shape(kind: str = "train", seq: int = 32, batch: int = 2) -> InputShape:
    return InputShape(f"smoke_{kind}", seq, batch, kind)
