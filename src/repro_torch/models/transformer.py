"""The LM zoo's sequence model: the JAX package's ``models/transformer.py``
as one ``nn.Module``, for its dense attention stacks (gemma2, and the
llama/qwen flavours' qkv bias and qk-norm).

The reference stacks the layers of each period position along a leading
``num_groups`` axis and scans over groups; the port keeps one module per
layer in absolute order (layer ``g · period + p`` is group g's position p;
``convert.lm_state_from_jax`` maps the one onto the other).  Mamba, mLSTM
and sLSTM mixers, MoE FFNs, the audio and vision frontends and the
encoder head come with later slices and raise ``NotImplementedError``
here; so does ``loss_fn``, which comes with training.

Weights are held in the activation dtype (the reference holds fp32 and
casts each to it at use, which rounds the same way); norm scales stay fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (MLP, Dense, RMSNorm, embed,
                                       init_embedding, unembed)
from repro_torch.models.moe import Parallel
from repro_torch.utils import resolve_device
from repro_torch.utils import softcap as _softcap

_LATER = {"mamba": "the Mamba slice", "mlstm": "the xLSTM slice",
          "slstm": "the xLSTM slice"}


class Layer(nn.Module):
    """One layer at period position p (absolute layer ≡ p mod period)."""

    def __init__(self, cfg: ModelConfig, p: int, **kw):
        super().__init__()
        kind = cfg.layer_kind(p)
        if kind not in (ATTN, ATTN_LOCAL):
            raise NotImplementedError(
                f"{cfg.name}: {kind} layers come with {_LATER.get(kind, kind)}")
        if cfg.uses_moe(p):
            raise NotImplementedError(f"{cfg.name}: MoE FFNs come with the "
                                      "MoE slice")
        dev = kw["device"]
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.mixer = attn_mod.Attention(cfg, **kw)
        self.norm2 = self.mlp = self.post_norm1 = self.post_norm2 = None
        if cfg.d_ff > 0:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.mlp_act,
                           **kw)
        if cfg.post_norms:
            self.post_norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            if self.mlp is not None:
                self.post_norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)


class LM(nn.Module):
    """Token-frontend decoder.  ``forward(tokens, par, mode=)`` is the
    reference's ``forward``; ``decode_step`` and ``init_caches`` its
    decode half.  Parameters live on ``device``: the card unless the caller
    passes ``"cpu"``.  Initialised from ``generator`` as ``init_lm`` does
    (LeCun dense weights, 0.02-normal embedding, zero norm scales and qkv
    biases), with the port's own draws."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if cfg.frontend != "token" or cfg.is_encoder:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.frontend} frontend"
                f"{' and encoder head' if cfg.is_encoder else ''} come with "
                "a later slice")
        device = resolve_device(device)
        dt = cfg.act_dtype
        self.cfg = cfg
        self.embedding = init_embedding(cfg.padded_vocab, cfg.d_model,
                                        generator, device, dt)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.d_model, cfg.padded_vocab, generator=generator,
            device=device, dtype=dt)
        self.layers = nn.ModuleList(
            Layer(cfg, i % cfg.period, generator=generator, device=device,
                  dtype=dt) for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    # -- forward (train / prefill) ------------------------------------------
    def _embed_inputs(self, tokens):
        """Returns (x (B,S,d), positions (B,S))."""
        cfg, dt = self.cfg, self.cfg.act_dtype
        x = embed(self.embedding, tokens, dt)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
        return self._scale_embed(x), pos

    def _scale_embed(self, x):
        if self.cfg.scale_embed:   # multiplied in the activation dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _apply_layer(self, layer: Layer, x, pos, par: Parallel, mode: str,
                     cache=None, decode_pos=None):
        """mode: train | prefill | decode.  Returns (x, new_cache)."""
        cfg = self.cfg
        h = layer.norm1(x)
        new_cache = None
        if mode == "decode":
            h, new_cache = attn_mod.attention_decode(
                layer.mixer, cfg, h, cache, decode_pos, kind=layer.kind)
        else:
            h, kv = attn_mod.attention(layer.mixer, cfg, h, pos,
                                       kind=layer.kind,
                                       use_kernels=par.use_kernels,
                                       impl=par.attn_impl)
            if mode == "prefill":
                new_cache = KVCache(*kv)
        if cfg.post_norms:
            h = layer.post_norm1(h)
        x = x + h
        if layer.mlp is not None:
            h = layer.mlp(layer.norm2(x))
            if cfg.post_norms:
                h = layer.post_norm2(h)
            x = x + h
        return x, new_cache

    def _readout(self, x):
        cfg = self.cfg
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = unembed(self.embedding, x)
        else:
            logits = self.lm_head(x)
        if cfg.final_softcap:
            logits = _softcap(logits.float(), cfg.final_softcap)
        return logits

    def forward(self, tokens, par: Parallel = Parallel(), *,
                mode: str = "train"):
        """Full-sequence pass over tokens (B, S).

        Returns (logits, aux_loss) for mode="train"; (logits, aux_loss,
        caches) for mode="prefill", caches a list of one ``KVCache`` of
        (B, S, n_kv, head_dim) per layer.  ``aux_loss`` is the MoE
        router's, 0 for these dense stacks."""
        x, pos = self._embed_inputs(tokens)
        caches = []
        for layer in self.layers:
            x, c = self._apply_layer(layer, x, pos, par, mode)
            caches.append(c)
        aux = torch.zeros((), device=x.device)
        if mode == "prefill" and par.prefill_last_only:
            # serving: only the last position's logits start decode
            return self._readout(x[:, -1:, :]), aux, caches
        logits = self._readout(x)
        if mode == "prefill":
            return logits, aux, caches
        return logits, aux

    # -- decode ---------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=None):
        """One zero ``KVCache`` of (batch, max_len, n_kv, head_dim) per
        layer."""
        dtype = dtype or self.cfg.act_dtype
        return [attn_mod.init_kv_cache(self.cfg, batch, max_len, dtype,
                                       self.device)
                for _ in self.layers]

    def decode_step(self, tokens, caches, pos: int,
                    par: Parallel = Parallel()):
        """One decode step.  tokens: (B, 1); pos: the current write
        position.  Returns (logits (B,1,V), caches), the caches updated in
        place."""
        x = self._scale_embed(embed(self.embedding, tokens,
                                    self.cfg.act_dtype))
        for layer, cache in zip(self.layers, caches):
            x, _ = self._apply_layer(layer, x, None, par, "decode",
                                     cache=cache, decode_pos=pos)
        return self._readout(x), caches
