"""Granite-20B-Code [arXiv:2405.04324] — dense decoder, GPT-BigCode arch.

52L, d_model=6144, 48 heads, MQA (kv=1), d_ff=24576, vocab=49152.
Plain GELU MLP (non-gated), biases on QKV, tied embeddings.
Adaptation: learned absolute positions (8k table) replaced by RoPE so the
32k-prefill shape is addressable.  MQA: the single KV head
is replicated across the model axis (cannot shard 1 head 16-way).
Pure full attention → ``long_500k`` is a documented skip.

The same config as the JAX package's ``configs/granite_20b.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    layer_pattern=(ATTN,),
    gated_mlp=False,
    mlp_act="gelu",
    tie_embeddings=True,
    remat="full",
    source="arXiv:2405.04324",
))
