"""Qwen3-32B [hf:Qwen/Qwen3-8B family card] — dense decoder, qk-norm GQA.

64L, d_model=5120, 64 heads (GQA kv=8), head_dim=128 (q-proj dim 8192 >
d_model), d_ff=25600, vocab=151936, SwiGLU, qk-norm, no QKV bias.
Full attention → ``long_500k`` skipped.

The same config as the JAX package's ``configs/qwen3_32b.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=(ATTN,),
    gated_mlp=True,
    mlp_act="silu",
    remat="full",
    source="hf:Qwen/Qwen3-8B",
))
