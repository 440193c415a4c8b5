"""Gemma-2 2B [arXiv:2408.00118] — dense decoder with alternating
local(4096-window)/global attention, logit softcaps, GeGLU, post-norms.

26L, d_model=2304, 8 heads (GQA kv=4), head_dim=256, d_ff=9216,
vocab=256000, attn softcap 50.0, final softcap 30.0, tied embeddings,
embeddings scaled by sqrt(d).

The same two configs as the JAX package's ``configs/gemma2_2b.py``.

``long_500k``: runs with the sliding-window decode variant (global layers
windowed at decode) — a beyond-paper variant recorded in DESIGN.md §5.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern=(ATTN_LOCAL, ATTN),
    gated_mlp=True,
    mlp_act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    post_norms=True,
    remat="full",
    source="arXiv:2408.00118",
))

# Sliding-window-only decode variant used for the long_500k shape: every
# layer is windowed, making decode memory O(window), not O(context).
CONFIG_SWA = register(CONFIG.replace(
    name="gemma2-2b-swa",
    layer_pattern=(ATTN_LOCAL, ATTN_LOCAL),
))
