"""Operations of one row of one DiT call (the denoiser), from the
configuration's shapes: every product (2·m·n·k) and each block's attention
(4·S²·d over all heads); elementwise work is not counted."""
from __future__ import annotations


def row_call_flops(cfg: dict) -> int:
    d, p, C, cd = cfg["d_model"], cfg["patch"], cfg["channels"], \
        cfg["cond_dim"]
    N = (cfg["image_size"] // p) ** 2
    S = N + 1                                  # the conditioning token
    pd = p * p * C
    f = 2 * N * pd * d + 2 * 2 * d * d + 2 * 2 * cd * d      # patch, t, y
    block = (2 * d * 6 * d                     # adaLN modulation
             + 2 * S * d * 3 * d               # qkv
             + 4 * S * S * d                   # q·kᵀ and p·v
             + 2 * S * d * d                   # output projection
             + 2 * 2 * S * d * 4 * d)          # MLP up and down
    f += cfg["num_layers"] * block
    f += 2 * d * 2 * d + 2 * N * d * pd        # output modulation, patches
    return f
