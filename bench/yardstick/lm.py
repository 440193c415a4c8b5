"""Operations a prefill needs, from the configuration's shapes: per token
twice the active parameters of each layer (q, k, v and o projections, the
router, top_k experts of three matrices each), causal attention over the
prompt, and the LM head at the last position only (one token is served
from it).  Capacity rows, padding and the logits of other positions do not
count."""
from __future__ import annotations

from bench.yardstick import attention


def prefill_flops(cfg: dict, L: int) -> int:
    d, H, Hkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    proj = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    ffn = d * cfg["num_experts"] + cfg["top_k"] * 3 * d * cfg["d_ff_expert"]
    layer = 2 * L * (proj + ffn) + attention.flops(1, L, L, H, hd, True)
    return cfg["num_layers"] * layer + 2 * d * cfg["vocab_size"]
