"""Jamba-1.5-Large (398B total) [arXiv:2403.19887] — hybrid Mamba+attention
with MoE.

72L, d_model=8192, 64 heads (GQA kv=8), vocab=65536.  Period-8 Jamba block:
attention at in-block index 4, Mamba elsewhere (1:7 ratio); MoE every 2nd
layer (16 experts, top-2, expert d_ff=24576), dense d_ff=24576 otherwise.
Mamba: d_state=16, d_conv=4, expand=2.

The same config as the JAX package's ``configs/jamba_15_large.py``.
"""
from repro_torch.configs.base import (ATTN, MAMBA, MambaConfig, ModelConfig,
                                      MoEConfig, register)

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every_n=2,
                  moe_offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    gated_mlp=True,
    mlp_act="silu",
    remat="full",
    source="arXiv:2403.19887",
))
