"""Qwen2-7B [arXiv:2407.10671] — dense decoder, GQA with QKV bias.

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064, SwiGLU.
Full attention → ``long_500k`` skipped.

The same config as the JAX package's ``configs/qwen2_7b.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    layer_pattern=(ATTN,),
    gated_mlp=True,
    mlp_act="silu",
    remat="full",
    source="arXiv:2407.10671",
))
