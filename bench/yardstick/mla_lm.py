"""Operations a prefill of the DeepSeek-V3 block needs, from the
configuration's shapes (DeepSeek-V3's ``config.json`` keys): per token
twice the active parameters of each layer (the latent attention's q,
kv-down, kv-up and o projections; in the first ``first_k_dense_replace``
layers the dense FFN, after them the router and ``num_experts_per_tok``
routed plus ``n_shared_experts`` shared experts of three matrices each),
causal attention at q·k's head dim and v's (``yardstick/mla.py``), and the
LM head at the last position only (one token is served from it).
Capacity rows, padding and the logits of other positions do not count."""
from __future__ import annotations

from bench.yardstick import mla


def prefill_flops(cfg: dict, L: int) -> int:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    proj = d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d
    expert = 3 * d * cfg["moe_intermediate_size"]
    moe = d * cfg["n_routed_experts"] + expert * (
        cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    dense = 3 * d * cfg["intermediate_size"]
    attn = mla.flops(1, L, L, H, dn + dr, dv, True)
    n, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    per = [2 * L * (proj + (dense if i < k else moe)) + attn
           for i in range(n)]
    return sum(per) + 2 * d * cfg["vocab_size"]
