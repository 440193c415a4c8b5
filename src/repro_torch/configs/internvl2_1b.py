"""InternVL2-1B [arXiv:2404.16821] — VLM: InternViT frontend + LM decoder.

LM backbone: 24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864,
vocab=151655, QKV bias, SwiGLU, tied embeddings.  The vision tower is a
stub: 256 pre-computed 1024-d patch embeddings an image, projected into
the LM by ``frontend_proj`` and put before the text tokens.  Full
attention → ``long_500k`` skipped.

The same config as the JAX package's ``configs/internvl2_1b.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    layer_pattern=(ATTN,),
    gated_mlp=True,
    mlp_act="silu",
    frontend="vision_patches",
    frontend_dim=1024,
    num_prefix_tokens=256,
    tie_embeddings=True,
    remat="none",
    source="arXiv:2404.16821",
))
