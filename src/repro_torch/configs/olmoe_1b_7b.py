"""OLMoE-1B-7B [arXiv:2409.02060] — MoE decoder, 64 experts top-8.

16L, d_model=2048, 16 heads (MHA kv=16), vocab=50304, qk-norm; every FFN
is MoE: 64 experts, top-8, expert d_ff=1024, SwiGLU experts.
Full attention → ``long_500k`` skipped.

The same config as the JAX package's ``configs/olmoe_1b_7b.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50304,
    qk_norm=True,
    layer_pattern=(ATTN,),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    gated_mlp=True,
    mlp_act="silu",
    remat="full",
    source="arXiv:2409.02060",
))
