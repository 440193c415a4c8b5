"""``prefill_batches`` for a configuration of the DeepSeek-V3 block
(``bench/references/mla_moe_lm.py``; its keys are DeepSeek-V3's
``config.json`` keys): the same closed loop of offline batches through
``ServeEngine``, the same layer-by-layer check, with the program's
configuration built from those keys."""
from __future__ import annotations

from bench.drivers import prefill_batches


class Driver(prefill_batches.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        # the base driver counts layers by ``num_layers``
        super().__init__(dict(config, num_layers=config["num_hidden_layers"]),
                         traffic, seed, device)

    def _model_config(self):
        from repro_torch.configs.base import (MLA, DeepSeekV3Config,
                                              MLAConfig, MoEConfig)
        c = self.cfg
        if c["q_lora_rank"] is not None or c["n_group"] != 1 or \
                c["topk_group"] != 1 or c["scoring_func"] != "sigmoid" or \
                c["topk_method"] != "noaux_tc" or not c["norm_topk_prob"]:
            raise ValueError(f"{c['name']}: a DeepSeek-V3 variant the "
                             "program does not serve")
        return DeepSeekV3Config(
            name=c["name"], arch_type="moe",
            num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            num_heads=c["num_attention_heads"],
            num_kv_heads=c["num_key_value_heads"],
            head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
            rope_theta=float(c["rope_theta"]), layer_pattern=(MLA,),
            moe=MoEConfig(num_experts=c["n_routed_experts"],
                          top_k=c["num_experts_per_tok"],
                          d_ff_expert=c["moe_intermediate_size"]),
            gated_mlp=True, mlp_act=c["hidden_act"],
            norm_eps=c["rms_norm_eps"], dtype=c["dtype"],
            mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                          qk_nope_head_dim=c["qk_nope_head_dim"],
                          qk_rope_head_dim=c["qk_rope_head_dim"],
                          v_head_dim=c["v_head_dim"]),
            routed_scaling_factor=c["routed_scaling_factor"],
            n_shared_experts=c["n_shared_experts"],
            first_k_dense=c["first_k_dense_replace"])
