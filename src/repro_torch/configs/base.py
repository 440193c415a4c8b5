"""Config dataclasses for the model zoo and input shapes.

Field for field the same as the JAX package's ``configs/base.py`` (same
names, defaults, layer kinds and parameter counts), kept as a copy so the
port never imports it; ``act_dtype`` is a torch dtype here.  Every config
of the reference registers: gemma2-2b, granite-20b, qwen2-7b, qwen3-32b,
olmoe-1b-7b, phi3.5-moe, jamba-1.5-large, xlstm-125m, hubert-xlarge and
internvl2-1b.

Beside them, and not in the reference: ``MLAConfig`` and
``DeepSeekV3Config``, a ``ModelConfig`` with the DeepSeek-V3 block's
settings (latent attention, sigmoid routing with a selection bias, shared
experts, leading dense layers), for moonlight-16b-a3b.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

# Layer kinds used in ``layer_pattern`` (the repeating period of the stack).
ATTN = "attn"          # full (global) self-attention
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MAMBA = "mamba"        # Mamba-1 selective SSM block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
MLA = "mla"            # latent attention (DeepSeek-V3; not in the reference)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # Which layers inside the repeating period use MoE FFN (None = all).
    every_n: int = 1           # layer i uses MoE iff i % every_n == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0      # mLSTM block up-projection factor
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense FFN hidden (0 = no separate FFN)
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- attention flavour ---
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0      # 0 = off (gemma2: 50.0)
    final_softcap: float = 0.0     # 0 = off (gemma2: 30.0)
    sliding_window: int = 0        # 0 = off
    rope_theta: float = 10_000.0
    # --- stack layout ---
    layer_pattern: tuple[str, ...] = (ATTN,)   # repeats to num_layers
    is_encoder: bool = False       # bidirectional, no decode step
    post_norms: bool = False       # gemma2-style post-sublayer norms
    # --- FFN flavour ---
    gated_mlp: bool = True         # SwiGLU/GeGLU vs plain GELU
    mlp_act: str = "silu"          # silu | gelu
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # --- embedding / head ---
    tie_embeddings: bool = False
    scale_embed: bool = False      # multiply embeddings by sqrt(d) (gemma)
    # --- frontend (audio/vlm carve-out stubs) ---
    frontend: str = "token"        # token | audio_frames | vision_patches
    frontend_dim: int = 0          # embedding dim produced by the stub
    num_prefix_tokens: int = 0     # vlm: image tokens prepended to text
    # --- misc ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # activation dtype
    remat: str = "none"            # none | full | dots  (checkpoint policy)
    source: str = ""               # citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} must be a multiple of "
            f"the layer period {len(self.layer_pattern)}")

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a 256 multiple so the
        vocab-parallel sharding divides evenly (MaxText-style padding;
        labels always index < vocab_size)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.period

    @property
    def act_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % self.period]

    def uses_moe(self, i: int) -> bool:
        m = self.moe
        return m is not None and (i % m.every_n) == m.moe_offset

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (analytic; used for roofline MODEL_FLOPS) ----
    def param_counts(self) -> dict:
        """Returns dict with total and active (per-token) parameter counts."""
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings and not self.is_encoder:
            total += self.vocab_size * d
        if self.frontend != "token" and self.frontend_dim:
            total += self.frontend_dim * d
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            t = 0
            if kind in (ATTN, ATTN_LOCAL):
                t += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                if self.qkv_bias:
                    t += (nq + 2 * nkv) * hd
            elif kind == MAMBA:
                mc = self.mamba or MambaConfig()
                din = mc.expand * d
                dtr = mc.dt_rank or -(-d // 16)
                t += d * 2 * din + din * mc.d_conv + din * (dtr + 2 * mc.d_state)
                t += dtr * din + din * mc.d_state + din + din * d
            elif kind == MLSTM:
                xc = self.xlstm or XLSTMConfig()
                din = int(xc.proj_factor * d)
                t += d * 2 * din + 3 * din * din // max(self.num_heads, 1) + 3 * din + din * d + din * xc.conv_kernel
            elif kind == SLSTM:
                xc = self.xlstm or XLSTMConfig()
                din = int(xc.slstm_proj_factor * d)
                t += 4 * d * d + 4 * d * d // max(self.num_heads, 1) + 4 * d
                t += d * 2 * din + din * d
            # FFN
            if self.uses_moe(i):
                m = self.moe
                per_expert = (3 if self.gated_mlp else 2) * d * m.d_ff_expert
                t += m.num_experts * per_expert + d * m.num_experts
            elif self.d_ff:
                t += (3 if self.gated_mlp else 2) * d * self.d_ff
            total += t
        return {"total": total, "active": self._active_params()}

    def _active_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        active = self.vocab_size * d
        if not self.tie_embeddings and not self.is_encoder:
            active += self.vocab_size * d
        if self.frontend != "token" and self.frontend_dim:
            active += self.frontend_dim * d
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            a = 0
            if kind in (ATTN, ATTN_LOCAL):
                a += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            elif kind == MAMBA:
                mc = self.mamba or MambaConfig()
                din = mc.expand * d
                dtr = mc.dt_rank or -(-d // 16)
                a += d * 2 * din + din * mc.d_conv + din * (dtr + 2 * mc.d_state)
                a += dtr * din + din * mc.d_state + din + din * d
            elif kind == MLSTM:
                xc = self.xlstm or XLSTMConfig()
                din = int(xc.proj_factor * d)
                a += d * 2 * din + 3 * din * din // max(self.num_heads, 1) + 3 * din + din * d
            elif kind == SLSTM:
                xc = self.xlstm or XLSTMConfig()
                din = int(xc.slstm_proj_factor * d)
                a += 4 * d * d + 4 * d * d // max(self.num_heads, 1)
                a += d * 2 * din + din * d
            if self.uses_moe(i):
                m = self.moe
                a += m.top_k * (3 if self.gated_mlp else 2) * d * m.d_ff_expert
                a += d * m.num_experts
            elif self.d_ff:
                a += (3 if self.gated_mlp else 2) * d * self.d_ff
            active += a
        return active


@dataclass(frozen=True)
class MLAConfig:
    """Latent attention's widths (DeepSeek-V3's config keys).  q is projected
    straight from the residual (``q_lora_rank`` null), k and v from one
    ``kv_lora_rank`` latent a token, with one ``qk_rope_head_dim`` rope key
    shared by the heads."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """A ``ModelConfig`` of the DeepSeek-V3 block: ``mla`` layers
    (``MLA``), whose FFN is dense for the first ``first_k_dense`` layers
    (width ``d_ff``) and, where ``uses_moe`` holds at the period position,
    an MoE after them, routed by sigmoid scores (experts selected by top-k
    of score + a per-expert bias, weighted by the selected scores
    renormalised over the k, times ``routed_scaling_factor``), beside
    ``n_shared_experts`` experts every token takes (one gated MLP of
    ``n_shared_experts · d_ff_expert``).  ``head_dim`` is q·k's."""
    mla: Optional[MLAConfig] = None
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    first_k_dense: int = 0

    def moe_layer(self, index: int) -> bool:
        """Whether layer ``index`` (absolute) is an MoE: ``uses_moe`` at
        its period position, past the leading dense layers."""
        return (index >= self.first_k_dense
                and self.uses_moe(index % self.period))

    def param_counts(self) -> dict:
        """Total and active (per-token) parameter counts; a layer's norms
        and the router's bias are left out, as ``ModelConfig`` leaves out
        norms."""
        d, H, m, e = self.d_model, self.num_heads, self.mla, self.moe
        attn = (d * H * m.qk_head_dim + d * (m.kv_lora_rank
                                             + m.qk_rope_head_dim)
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)
        expert = 3 * d * e.d_ff_expert
        total = active = 2 * self.vocab_size * d
        for i in range(self.num_layers):
            if self.moe_layer(i):
                shared = self.n_shared_experts * expert + d * e.num_experts
                total += attn + e.num_experts * expert + shared
                active += attn + e.top_k * expert + shared
            else:
                total += attn + 3 * d * self.d_ff
                active += attn + 3 * d * self.d_ff
        return {"total": total, "active": active}


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (registers the configs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
