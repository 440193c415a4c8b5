"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), vocab=32064; every FFN is MoE:
16 experts, top-2, expert d_ff=6400, SwiGLU experts.
Routing simplification: softmax top-k with renormalised gates stands in for
sparsemixer-v2.  Full attention → ``long_500k`` skipped.

The same config as the JAX package's ``configs/phi35_moe.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=32064,
    layer_pattern=(ATTN,),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    gated_mlp=True,
    mlp_act="silu",
    remat="full",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
