"""The LM zoo's sequence model: the JAX package's ``models/transformer.py``
as one ``nn.Module``: attention, Mamba, mLSTM and sLSTM mixers, with dense
or MoE FFNs (gemma2, granite, the qwens, olmoe, phi3.5-moe, jamba, xlstm),
the audio and vision frontends (hubert's frames, internvl's patches) and
the encoder head, and ``loss_fn``, the loss the trainers take.

The reference stacks the layers of each period position along a leading
``num_groups`` axis and scans over groups; the port keeps one module per
layer in absolute order (layer ``g · period + p`` is group g's position p;
``convert.lm_state_from_jax`` maps the one onto the other).  A layer's
decode cache is a ``KVCache`` (attention, written in place), a
``LatentCache`` (latent attention, written in place) or its mixer's
recurrent state (Mamba, mLSTM, sLSTM; replaced each step).

Beside the reference's layers, the DeepSeek-V3 block
(``configs/base.py::DeepSeekV3Config``, moonlight-16b-a3b): latent
attention (``models/mla.py``), a dense FFN in the first ``first_k_dense``
layers and sigmoid-routed MoE with shared experts after them (a layer
knows its absolute index).  ``init_lm`` does not draw it (the reference
has no such initialiser): its weights are loaded by name.

Weights are held in the activation dtype for serving (the reference holds
fp32 and casts each to it at use, which rounds the same way), or in fp32
for training (``param_dtype``; every layer casts at use, so the forward is
the reference's); norm scales, Mamba's ``A_log`` and ``D`` and sLSTM's
``w_r`` and ``b``, which the reference uses uncast, stay fp32.
``LM(cfg)`` allocates them and draws nothing; ``init_lm(key, cfg)`` draws
the reference's initial weights from a threefry key.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA, MLA, MLSTM,
                                      SLSTM, DeepSeekV3Config, ModelConfig)
from repro_torch.convert import lm_layer_items, lm_state_items
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (MLP, Dense, RMSNorm, embed,
                                       init_embedding, unembed)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.moe import MoE, Parallel, moe_apply, pin
from repro_torch.utils import resolve_device
from repro_torch.utils import softcap as _softcap

# kind -> (mixer module, full-sequence forward, decode step, initial state)
RECURRENT = {
    MAMBA: (ssm_mod.Mamba, ssm_mod.mamba_forward, ssm_mod.mamba_decode,
            ssm_mod.init_mamba_state),
    MLSTM: (xlstm_mod.mLSTM, xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode,
            xlstm_mod.init_mlstm_state),
    SLSTM: (xlstm_mod.sLSTM, xlstm_mod.slstm_forward, xlstm_mod.slstm_decode,
            xlstm_mod.init_slstm_state),
}


FRONTENDS = ("token", "vision_patches", "audio_frames")


class Layer(nn.Module):
    """Layer ``index`` of the stack (at period position index mod
    period)."""

    def __init__(self, cfg: ModelConfig, index: int, **kw):
        super().__init__()
        p = index % cfg.period
        kind = cfg.layer_kind(p)
        dev = kw["device"]
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if kind in (ATTN, ATTN_LOCAL):
            self.mixer = attn_mod.Attention(cfg, **kw)
        elif kind == MLA:
            self.mixer = mla_mod.MLA(cfg, **kw)
        elif kind in RECURRENT:
            self.mixer = RECURRENT[kind][0](cfg, **kw)
        else:
            raise ValueError(kind)
        self.norm2 = self.mlp = self.moe = None
        self.post_norm1 = self.post_norm2 = None
        has_ffn = _has_ffn(cfg, p)
        if has_ffn:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            if (cfg.moe_layer(index) if isinstance(cfg, DeepSeekV3Config)
                    else cfg.uses_moe(p)):
                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               cfg.mlp_act, **kw)
        if cfg.post_norms:
            self.post_norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            if has_ffn:
                self.post_norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)


def _has_ffn(cfg: ModelConfig, p: int) -> bool:
    """The reference's rule: an MoE FFN, or a dense one where ``d_ff > 0``
    (olmoe and phi3.5 have ``d_ff = 0``) and the mixer is not an xLSTM
    block, which carries its own projections."""
    return cfg.uses_moe(p) or (cfg.d_ff > 0 and
                               cfg.layer_kind(p) not in (MLSTM, SLSTM))


class LM(nn.Module):
    """The reference's sequence model.  ``forward(batch, par, mode=)`` is
    its ``forward``; ``decode_step`` and ``init_caches`` its decode half
    (not for an encoder).  Parameters live on ``device``: the card unless
    the caller passes ``"cpu"``; their dtype is ``param_dtype``, the
    activation dtype unless given (training holds fp32).  They are
    allocated, not drawn (norm scales and qkv biases zero): ``init_lm``
    draws them from a key, or ``convert.lm_state_from_jax`` loads a
    reference tree."""

    def __init__(self, cfg: ModelConfig, *, device=None, param_dtype=None):
        super().__init__()
        if cfg.frontend not in FRONTENDS:
            raise ValueError(cfg.frontend)
        device = resolve_device(device)
        dt = param_dtype or cfg.act_dtype
        self.cfg = cfg
        # an encoder never reads its token table; the reference draws it all
        # the same, so the trees line up
        self.embedding = init_embedding(cfg.padded_vocab, cfg.d_model,
                                        device, dt)
        self.frontend_proj = self.mask_embed = None
        if cfg.frontend != "token":
            self.frontend_proj = Dense(cfg.frontend_dim, cfg.d_model,
                                       device=device, dtype=dt)
        if cfg.frontend == "audio_frames":
            self.mask_embed = nn.Parameter(torch.empty(cfg.d_model,
                                                       device=device,
                                                       dtype=dt))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        head = Dense(cfg.d_model, cfg.padded_vocab, device=device, dtype=dt)
        self.lm_head = self.enc_head = None
        if cfg.is_encoder:
            self.enc_head = head
        elif not cfg.tie_embeddings:
            self.lm_head = head
        self.layers = nn.ModuleList(
            Layer(cfg, i, device=device, dtype=dt)
            for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    # -- forward (train / prefill) ------------------------------------------
    def _embed_inputs(self, batch):
        """Returns (x (B,S,d), positions (B,S)) for the reference's batch
        of tensors on the LM's device: ``{"tokens"}``, ``{"patches",
        "tokens"}`` (the projected patches before the token embeddings) or
        ``{"frames", "mask"}`` (the projected frames, ``mask_embed`` where
        the mask is True)."""
        cfg, dt = self.cfg, self.cfg.act_dtype
        if cfg.frontend == "audio_frames":
            x = torch.where(batch["mask"][..., None], self.mask_embed.to(dt),
                            self.frontend_proj(batch["frames"].to(dt)))
        else:
            x = embed(self.embedding, batch["tokens"], dt)
            if cfg.frontend == "vision_patches":
                x = torch.cat([self.frontend_proj(batch["patches"].to(dt)),
                               x], 1)
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device).expand(B, S)
        return self._scale_embed(x), pos

    def _scale_embed(self, x):
        if self.cfg.scale_embed:   # multiplied in the activation dtype
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _apply_layer(self, layer: Layer, x, pos, par: Parallel, mode: str,
                     cache=None, decode_pos=None):
        """mode: train | prefill | decode.  Returns (x, aux, new_cache),
        aux the MoE router's load-balance loss (None without an MoE)."""
        cfg = self.cfg
        aux = None
        h = layer.norm1(x)
        new_cache = None
        if layer.kind in RECURRENT:
            _, forward, decode, _ = RECURRENT[layer.kind]
            if mode == "decode":
                h, new_cache = decode(layer.mixer, cfg, h, cache)
            elif mode == "prefill":
                h, new_cache = forward(layer.mixer, cfg, h, return_state=True)
            else:
                h = forward(layer.mixer, cfg, h)
        elif layer.kind == MLA:
            if mode == "decode":
                h, new_cache = mla_mod.mla_decode(layer.mixer, cfg, h, cache,
                                                  decode_pos)
            else:
                h, latent = mla_mod.mla_attention(
                    layer.mixer, cfg, h, pos, use_kernels=par.use_kernels)
                new_cache = latent if mode == "prefill" else None
        elif mode == "decode":
            h, new_cache = attn_mod.attention_decode(
                layer.mixer, cfg, h, cache, decode_pos, kind=layer.kind)
        else:
            h, kv = attn_mod.attention(layer.mixer, cfg, h, pos,
                                       kind=layer.kind,
                                       use_kernels=par.use_kernels,
                                       impl=par.attn_impl, par=par)
            if mode == "prefill":
                new_cache = KVCache(*kv)
        if cfg.post_norms:
            h = layer.post_norm1(h)
        x = x + h
        if layer.norm2 is not None:
            h = layer.norm2(x)
            if layer.moe is not None:
                h, aux = moe_apply(layer.moe, cfg, h, par)
            else:
                h = layer.mlp(h)
            if cfg.post_norms:
                h = layer.post_norm2(h)
            x = x + h
        return x, aux, new_cache

    def _readout(self, x, par: Parallel = Parallel()):
        cfg = self.cfg
        x = self.final_norm(x)
        if cfg.is_encoder:
            logits = self.enc_head(x)
        elif cfg.tie_embeddings:
            logits = unembed(self.embedding, x)
        else:
            logits = self.lm_head(x)
        if cfg.final_softcap:
            logits = _softcap(logits.float(), cfg.final_softcap)
        return pin(logits, par.logits_spec)

    def forward(self, batch, par: Parallel = Parallel(), *,
                mode: str = "train"):
        """Full-sequence pass over ``batch``: the reference's batch dict
        (``_embed_inputs``), or a token tensor (B, S).

        Returns (logits, aux_loss) for mode="train"; (logits, aux_loss,
        caches) for mode="prefill", caches a list with one entry per layer:
        a ``KVCache`` of (B, S, n_kv, head_dim), a ``LatentCache`` of (B, S,
        kv_lora_rank) and (B, S, qk_rope_head_dim), or the mixer's recurrent
        state after the last position.  ``aux_loss`` sums the MoE
        routers' load-balance losses over the layers (0 for dense
        stacks).  With ``cfg.remat == "full"`` and grad on, each layer's
        forward is recomputed in the backward (``torch.utils.checkpoint``),
        as the reference's ``jax.checkpoint`` of each group: the same
        numbers, less memory."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        x, pos = self._embed_inputs(batch)
        caches = []
        aux = torch.zeros((), device=x.device)
        remat = (self.cfg.remat == "full" and mode == "train"
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if remat:
                x, aux_l = checkpoint(self._remat_layer, layer, x, pos, par,
                                      use_reentrant=False)
                c = None
            else:
                x, aux_l, c = self._apply_layer(layer, x, pos, par, mode)
            if aux_l is not None:
                aux = aux + aux_l
            caches.append(c)
            if (i + 1) % self.cfg.period == 0:      # after each group
                x = pin(x, par.resid_spec)
        if mode == "prefill" and par.prefill_last_only:
            # serving: only the last position's logits start decode
            return self._readout(x[:, -1:, :], par), aux, caches
        logits = self._readout(x, par)
        if mode == "prefill":
            return logits, aux, caches
        return logits, aux

    def _remat_layer(self, layer: Layer, x, pos, par: Parallel):
        x, aux, _ = self._apply_layer(layer, x, pos, par, "train")
        return x, aux

    # -- decode ---------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=None):
        """One cache per layer: a zero ``KVCache`` of (batch, max_len,
        n_kv, head_dim), a zero ``LatentCache`` of max_len positions, or the
        mixer's initial recurrent state."""
        cfg, dtype = self.cfg, dtype or self.cfg.act_dtype

        def one(kind):
            if kind in RECURRENT:
                return RECURRENT[kind][3](cfg, batch, dtype, self.device)
            if kind == MLA:
                return mla_mod.init_latent_cache(cfg, batch, max_len, dtype,
                                                 self.device)
            return attn_mod.init_kv_cache(cfg, batch, max_len, dtype,
                                          self.device)
        return [one(layer.kind) for layer in self.layers]

    def decode_step(self, tokens, caches, pos: int,
                    par: Parallel = Parallel()):
        """One decode step.  tokens: (B, 1); pos: the current write
        position.  Returns (logits (B,1,V), caches): the same list, its
        KV caches written in place and its recurrent states replaced by
        the new ones.  ``par.decode_cache`` ("scan_ys" or "carry", checked
        by ``Parallel``) picks how the reference threads its stacked caches
        through the scan over groups; the port's per-layer list is written
        the same way under both, so both give the same logits and caches."""
        x = self._scale_embed(embed(self.embedding, tokens,
                                    self.cfg.act_dtype))
        for i, layer in enumerate(self.layers):
            x, _, caches[i] = self._apply_layer(layer, x, None, par,
                                                "decode", cache=caches[i],
                                                decode_pos=pos)
        return self._readout(x, par), caches


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _nll(logits, labels):
    """-log softmax(logits)[label] per position, in fp32."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def loss_fn(lm: LM, batch, par: Parallel = Parallel(use_kernels=False)):
    """The reference's ``loss_fn``: the masked-prediction loss of an
    encoder (the mean NLL of ``labels`` over the masked frames, the count
    at least 1), next-token cross-entropy over the text of a VLM (the
    patch positions excluded), or over the tokens; plus the MoE routers'
    load-balance loss, ``router_aux_weight · aux / num_layers``.  Returns
    (loss, {"ce", "aux"}), 0-d fp32 tensors on the LM's device.  By
    default on the plain attention route, as the reference's (its
    ``Parallel`` leaves Pallas off): a loss is for training, and the
    kernels have no backward."""
    cfg = lm.cfg
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    logits, aux = lm(batch, par, mode="train")
    logits = logits.float()
    if cfg.is_encoder:
        m = batch["mask"]
        nll = _nll(logits, batch["labels"])
        ce = (nll * m).sum() / torch.clamp(m.sum(), min=1)
    else:
        tokens = batch["tokens"]
        if cfg.frontend == "vision_patches":
            logits = logits[:, batch["patches"].shape[1]:]
        ce = _nll(logits[:, :-1], tokens[:, 1:]).mean()
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    loss = ce + aux_w * aux / max(cfg.num_layers, 1)
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# init: the reference's initial weights from a key
# ---------------------------------------------------------------------------
# A leaf is drawn in pieces of at most this many values (over all its
# keys), each piece with the counters the whole draw gives it, so the bits
# are one draw's and a piece's int64 temporaries stay a few hundred MB
# (gemma2-2b's embedding alone is 590 M values).
DRAW_PIECE = 1 << 24


def _draw(fn, keys, shape, device) -> torch.Tensor:
    """``fn(keys, shape)`` (``prng.normal`` or a truncated normal) for the
    batch ``keys`` (..., 2), drawn piece by piece into one float32 tensor
    (..., *shape) on ``device``."""
    batch = keys.shape[:-1]
    n = 1
    for s in shape:
        n *= int(s)
    per_key = max(DRAW_PIECE // max(1, int(np.prod(batch, dtype=np.int64))),
                  1)
    out = torch.empty((*batch, n), device=device)
    for start in range(0, n, per_key):
        stop = min(start + per_key, n)
        out[..., start:stop] = fn(keys, (stop - start,), device, start)
    return out.reshape(*batch, *shape)


def _lecun(keys, shape, device, fan_in_axes=(0,)) -> torch.Tensor:
    """The reference's ``lecun_init``: a truncated normal on [-2, 2] times
    1/sqrt(fan-in), the fan-in the product of ``shape`` over
    ``fan_in_axes`` (axis 0 by default, also for the (E, d, fe) experts,
    whose std is 1/sqrt(E) there)."""
    fan_in = int(np.prod([shape[a] for a in fan_in_axes]))
    std = float(np.float32(1.0 / np.sqrt(max(fan_in, 1))))
    return _draw(lambda k, s, d, o: prng.truncated_normal(k, -2.0, 2.0, s, d,
                                                          o),
                 keys, shape, device).mul_(std)


def _zeros(keys, shape, device) -> torch.Tensor:
    return torch.zeros((*keys.shape[:-1], *shape), device=device)


def _normal(keys, shape, device, stddev: float) -> torch.Tensor:
    return _draw(prng.normal, keys, shape, device).mul_(
        float(np.float32(stddev)))


# The trees below hold LAZY leaves: each is a zero-argument call that draws
# it, so that ``init_lm`` can draw one leaf, load it and drop it before the
# next (``init_lm_tree`` calls them all).
lazy = functools.partial


def _dense(keys, d_in: int, d_out: int, device, bias: bool = False) -> dict:
    kw, _ = np.moveaxis(prng.split(keys), -2, 0)
    p = {"w": lazy(_lecun, kw, (d_in, d_out), device)}
    if bias:
        p["b"] = lazy(_zeros, keys, (d_out,), device)
    return p


def _fill(keys, values, device) -> torch.Tensor:
    """A constant leaf: ``values`` (a 1-D float32 array) for every key of
    the batch."""
    return torch.tensor(values, device=device).expand(
        *keys.shape[:-1], len(values)).clone()


def _dt_bias(keys, din: int, device) -> torch.Tensor:
    return ssm_mod.dt_bias(prng.uniform(keys, (din,), device=device))


def _a_log(keys, din: int, N: int, device) -> torch.Tensor:
    a = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device))
    return a.expand(*keys.shape[:-1], din, N).clone()


def _mamba_tree(keys, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_mamba``: ``split(key, 8)``; ks[0] draws the
    dt bias (the inverse softplus of a log-uniform dt on [1e-3, 1e-1]),
    ``A_log`` is log(1..N) for every channel, ``D`` ones, ``conv_b``
    zeros; the projections and the conv take ks[1], ks[2], ks[4], ks[5]
    and ks[6] straight (no ``init_dense`` split), each at its axis-0 fan-in
    (the (d_conv, d_inner) conv at std 1/√d_conv)."""
    mc, din, dtr = ssm_mod._dims(cfg)
    d, N = cfg.d_model, mc.d_state
    ks = np.moveaxis(prng.split(keys, 8), -2, 0)
    return {"in_proj": {"w": lazy(_lecun, ks[1], (d, 2 * din), device)},
            "conv_w": lazy(_lecun, ks[2], (mc.d_conv, din), device),
            "conv_b": lazy(_zeros, ks[3], (din,), device),
            "x_proj": {"w": lazy(_lecun, ks[4], (din, dtr + 2 * N), device)},
            "dt_proj": {"w": lazy(_lecun, ks[5], (dtr, din), device),
                        "b": lazy(_dt_bias, ks[0], din, device)},
            "A_log": lazy(_a_log, keys, din, N, device),
            "D": lazy(_fill, keys, np.ones(din, np.float32), device),
            "out_proj": {"w": lazy(_lecun, ks[6], (din, d), device)}}


def _mlstm_tree(keys, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_mlstm``: ``split(key, 10)``; the input gate's
    weight and (zero) bias both take ks[6], the forget gate's bias is 3.0
    (open forget gates)."""
    xc = xlstm_mod._xc(cfg)
    d, H = cfg.d_model, cfg.num_heads
    din = int(xc.proj_factor * d)
    ks = np.moveaxis(prng.split(keys, 10), -2, 0)
    return {"in_proj": {"w": lazy(_lecun, ks[0], (d, 2 * din), device)},
            "conv_w": lazy(_lecun, ks[1], (xc.conv_kernel, din), device),
            "conv_b": lazy(_zeros, ks[2], (din,), device),
            "wq": {"w": lazy(_lecun, ks[3], (din, din), device)},
            "wk": {"w": lazy(_lecun, ks[4], (din, din), device)},
            "wv": {"w": lazy(_lecun, ks[5], (din, din), device)},
            "w_igate": {"w": lazy(_lecun, ks[6], (din, H), device),
                        "b": lazy(_zeros, ks[6], (H,), device)},
            "w_fgate": {"w": lazy(_lecun, ks[7], (din, H), device),
                        "b": lazy(_fill, keys, np.full(H, 3.0, np.float32),
                                  device)},
            "head_norm": {"scale": lazy(_zeros, ks[8], (din,), device)},
            "out_proj": {"w": lazy(_lecun, ks[9], (din, d), device)}}


def _slstm_tree(keys, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_slstm``: ``split(key, 7)``; ``w_r`` (H, hd,
    4·hd) at its axis-0 fan-in (std 1/√H), the bias zeros for the z and i
    gates, 3.0 for f, zeros for o."""
    xc = xlstm_mod._xc(cfg)
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    dff = int(xc.slstm_proj_factor * d)
    ks = np.moveaxis(prng.split(keys, 7), -2, 0)
    b = np.concatenate([np.zeros(2 * d), np.full(d, 3.0), np.zeros(d)])
    return {"w_x": {"w": lazy(_lecun, ks[0], (d, 4 * d), device)},
            "w_r": lazy(_lecun, ks[1], (H, hd, 4 * hd), device),
            "b": lazy(_fill, keys, b.astype(np.float32), device),
            "head_norm": {"scale": lazy(_zeros, ks[2], (d,), device)},
            "up_proj": {"w": lazy(_lecun, ks[3], (d, 2 * dff), device)},
            "down_proj": {"w": lazy(_lecun, ks[4], (dff, d), device)}}


def _moe_tree(keys, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_moe``: ``split(key, 4)`` gives the router,
    up, down and gate."""
    m = cfg.moe
    d, fe, E = cfg.d_model, m.d_ff_expert, m.num_experts
    ks = np.moveaxis(prng.split(keys, 4), -2, 0)
    p = {"w_router": lazy(_lecun, ks[0], (d, E), device),
         "experts_up": lazy(_lecun, ks[1], (E, d, fe), device),
         "experts_down": lazy(_lecun, ks[2], (E, fe, d), device, (1,))}
    if cfg.gated_mlp:
        p["experts_gate"] = lazy(_lecun, ks[3], (E, d, fe), device)
    return p


def _attention_tree(keys, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_attention``: ``split(key, 6)`` gives q, k, v,
    o and the two qk-norms."""
    d, hd = cfg.d_model, cfg.head_dim
    a = np.moveaxis(prng.split(keys, 6), -2, 0)
    mixer = {"wq": _dense(a[0], d, cfg.num_heads * hd, device, cfg.qkv_bias),
             "wk": _dense(a[1], d, cfg.num_kv_heads * hd, device,
                          cfg.qkv_bias),
             "wv": _dense(a[2], d, cfg.num_kv_heads * hd, device,
                          cfg.qkv_bias),
             "wo": _dense(a[3], cfg.num_heads * hd, d, device)}
    if cfg.qk_norm:
        mixer["q_norm"] = {"scale": lazy(_zeros, a[4], (hd,), device)}
        mixer["k_norm"] = {"scale": lazy(_zeros, a[5], (hd,), device)}
    return mixer


_MIXER_TREES = {ATTN: _attention_tree, ATTN_LOCAL: _attention_tree,
                MAMBA: _mamba_tree, MLSTM: _mlstm_tree, SLSTM: _slstm_tree}


def _layer_tree(keys, cfg: ModelConfig, p: int, device) -> dict:
    """The reference's ``_init_layer`` for the batch ``keys`` (G, 2), one
    per group: every leaf stacked along G, as its ``vmap`` stacks them."""
    ks = np.moveaxis(prng.split(keys, 6), -2, 0)
    kind, d = cfg.layer_kind(p), cfg.d_model
    layer = {"norm1": {"scale": lazy(_zeros, ks[0], (d,), device)},
             "mixer": _MIXER_TREES[kind](ks[1], cfg, device)}
    has_ffn = _has_ffn(cfg, p)
    if has_ffn:
        layer["norm2"] = {"scale": lazy(_zeros, ks[2], (d,), device)}
        if cfg.uses_moe(p):
            layer["moe"] = _moe_tree(ks[3], cfg, device)
        else:
            m = np.moveaxis(prng.split(ks[3], 3), -2, 0)
            layer["mlp"] = {
                "w_up": lazy(_lecun, m[0], (d, cfg.d_ff), device),
                "w_down": lazy(_lecun, m[1], (cfg.d_ff, d), device)}
            if cfg.gated_mlp:
                layer["mlp"]["w_gate"] = lazy(_lecun, m[2], (d, cfg.d_ff),
                                              device)
    if cfg.post_norms:
        layer["post_norm1"] = {"scale": lazy(_zeros, ks[4], (d,), device)}
        if has_ffn:
            layer["post_norm2"] = {"scale": lazy(_zeros, ks[5], (d,),
                                                 device)}
    return layer


def _lazy_tree(key, cfg: ModelConfig, device):
    """The reference's ``init_lm`` key layout: ``key, gkey = split(key)``;
    ``split(key, 5)`` gives the embedding (0.02·normal), the frontend's
    projection, the audio mask embedding (0.02·normal), the final norm
    (zeros) and the head (``lm_head``, or an encoder's ``enc_head``);
    ``split(gkey, num_groups)`` one key a group, each split by ``period``
    into its layers' keys.  Returns (the tree without
    ``groups``, the layer keys (num_groups, period, 2))."""
    LM(cfg, device="meta")                # refuses what the LM refuses
    if MLA in cfg.layer_pattern:
        raise NotImplementedError(f"{cfg.name}: the reference has no initial "
                                  "weights of latent attention; load them "
                                  "by name")
    key, gkey = prng.split(np.asarray(key, np.uint32))
    ks = prng.split(key, 5)
    d = cfg.d_model
    top = {"embed": {"embedding": lazy(_normal, ks[0], (
               cfg.padded_vocab, d), device, 0.02)}}
    if cfg.frontend != "token":
        top["frontend_proj"] = _dense(ks[1], cfg.frontend_dim, d, device)
        if cfg.frontend == "audio_frames":
            top["mask_embed"] = lazy(_normal, ks[2], (d,), device, 0.02)
    top["final_norm"] = {"scale": lazy(_zeros, ks[3], (d,), device)}
    # an encoder's head takes the key an untied LM head would
    if not cfg.tie_embeddings and not cfg.is_encoder:
        top["lm_head"] = _dense(ks[4], d, cfg.padded_vocab, device)
    if cfg.is_encoder:
        top["enc_head"] = _dense(ks[4], d, cfg.padded_vocab, device)
    return top, prng.split(prng.split(gkey, cfg.num_groups), cfg.period)


def _paths(node, prefix: str = ""):
    if isinstance(node, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in node.items()}
    return prefix[:-1]


def skeleton(cfg: ModelConfig) -> dict:
    """The reference's ``init_lm`` tree for ``cfg`` with every leaf its
    path (``groups/p0/mixer/wq/w``); nothing is drawn."""
    top, lkeys = _lazy_tree(prng.PRNGKey(0), cfg, "meta")
    top["groups"] = {f"p{p}": _layer_tree(lkeys[:, p], cfg, p, "meta")
                     for p in range(cfg.period)}
    return _paths(top)


def _drawn(node):
    if isinstance(node, dict):
        return {k: _drawn(v) for k, v in node.items()}
    return node()


def init_lm_tree(key, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_lm(key, cfg)`` tree, drawn on ``device`` (the
    card unless the caller passes ``"cpu"``) in float32, leaf by leaf.
    Within a few ulps of the reference (``prng.normal``,
    ``prng.truncated_normal``)."""
    device = resolve_device(device)
    top, lkeys = _lazy_tree(key, cfg, device)
    params = _drawn(top)
    params["groups"] = {f"p{p}": _drawn(_layer_tree(lkeys[:, p], cfg, p,
                                                    device))
                        for p in range(cfg.period)}
    return params


def init_lm(key, cfg: ModelConfig, device=None, param_dtype=None) -> LM:
    """An ``LM`` on ``device`` holding the reference's initial weights for
    ``key``: ``init_lm_tree``'s leaves, drawn one at a time in float32 and
    loaded into the allocated parameters (cast to ``param_dtype``, the
    activation dtype unless given), group by group.  Under the reference's ``vmap`` each group's draws are
    its own key's, so a group drawn alone gives the same bits; the peak is
    the model plus one leaf in float32."""
    device = resolve_device(device)
    lm = LM(cfg, device=device, param_dtype=param_dtype)
    state = lm.state_dict()
    top, lkeys = _lazy_tree(key, cfg, device)
    items = [lm_state_items(top, cfg)]
    for g in range(cfg.num_groups):
        for p in range(cfg.period):
            items.append(lm_layer_items(
                f"layers.{g * cfg.period + p}.",
                _layer_tree(lkeys[g:g + 1, p], cfg, p, device), 0))
    with torch.no_grad():
        for name, load in itertools.chain(*items):
            state[name].copy_(load())
    return lm
