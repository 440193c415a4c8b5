"""HuBERT X-Large [arXiv:2106.07447] — audio encoder (wav2vec2 arch).

48L, d_model=1280, 16 heads (MHA), d_ff=5120, vocab=504 (k-means target
codebook).  Encoder-only: bidirectional attention, masked-prediction loss,
no decode step.  The frontend is a stub: pre-computed 512-d frame
embeddings, projected into the model by ``frontend_proj``; HuBERT's conv
positional embedding is replaced by RoPE.

The same config as the JAX package's ``configs/hubert_xlarge.py``.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=(ATTN,),
    is_encoder=True,
    gated_mlp=False,
    mlp_act="gelu",
    frontend="audio_frames",
    frontend_dim=512,
    remat="full",
    source="arXiv:2106.07447",
))
