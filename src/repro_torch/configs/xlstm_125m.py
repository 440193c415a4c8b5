"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, attention-free.

12 blocks, d_model=768, 4 heads, vocab=50304, d_ff=0 (the xLSTM blocks
carry their own up/down projections).  Alternating (mLSTM, sLSTM) period.

The same config as the JAX package's ``configs/xlstm_125m.py``.
"""
from repro_torch.configs.base import (MLSTM, SLSTM, ModelConfig, XLSTMConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=(MLSTM, SLSTM),
    xlstm=XLSTMConfig(),
    tie_embeddings=True,
    remat="none",
    source="arXiv:2405.04517",
))
