"""Moonlight-16B-A3B (moonshotai; DeepSeek-V3's block, ``model_type``
``deepseek_v3``): https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json

27 layers, d_model 2048, vocab 163,840, rope θ 50,000, RMSNorm eps 1e-5.
Latent attention: 16 heads, q projected straight (``q_lora_rank`` null),
a 512-wide kv latent, q·k at 128 + 64 (rope) and v at 128.  Layer 0 is a
dense SwiGLU of 11,264; the 26 after it are MoE: 64 routed experts of
1,408, top-6, sigmoid scores with a selection bias (``noaux_tc``, one
group), gates renormalised over the 6 and scaled by 2.446, and 2 shared
experts.  No multi-token prediction layer.  Not in the JAX package.
"""
from repro_torch.configs.base import (MLA, DeepSeekV3Config, MLAConfig,
                                      MoEConfig, register)

CONFIG = register(DeepSeekV3Config(
    name="moonlight-16b-a3b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=11264,
    vocab_size=163840,
    rope_theta=50000.0,
    layer_pattern=(MLA,),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408),
    gated_mlp=True,
    mlp_act="silu",
    norm_eps=1e-5,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    routed_scaling_factor=2.446,
    n_shared_experts=2,
    first_k_dense=1,
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B",
))
