"""Plain reference of the DeepSeek-V3 block's prefill (Moonlight-16B-A3B,
``model_type`` ``deepseek_v3``): token embedding; per layer a pre-norm
causal latent attention, then a pre-norm FFN, dense SwiGLU in the first
``first_k_dense_replace`` layers and after them a sparse MoE of SwiGLU
experts beside ``n_shared_experts`` shared ones; a final RMSNorm and the
LM head.  The configuration's keys are DeepSeek-V3's ``config.json``
keys.

Latent attention, as DeepSeek-V3's ``modeling_deepseek.py`` computes it
with ``q_lora_rank`` null: q = x·Wq split into each head's q_nope (128)
and q_pe (64); x·Wkv_a split into the latent (512), RMS-normed, and one
k_pe (64) every head shares; the normed latent · Wkv_b split into each
head's k_nope (128) and v (128); rope on q_pe and k_pe (each viewed as
pairs, de-interleaved, then ``rotate_half``), θ ``rope_theta``; scores of
[q_nope, q_pe] · [k_nope, k_pe] at (128 + 64)^−½, causal softmax, P·v, Wo.
Computed here in blocks of ``QUERY_BLOCK`` queries, so that 4 × 8,192
positions fit.

Routing, as its ``MoEGate`` with ``scoring_func`` sigmoid and
``topk_method`` ``noaux_tc`` at one group: fp32 logits, sigmoid scores,
the top ``num_experts_per_tok`` of score + the selection bias chosen (the
lower expert index first among equal values), their scores over their sum
(+ 1e-20, ``norm_topk_prob``) times ``routed_scaling_factor`` the gates.

Departures from the published model, each as the program serves it:

* RMSNorm scales use the ``1 + scale`` convention (the same function);
* the tokens of a wave are routed together, and each expert keeps at most
  ``capacity_multiple`` · ⌈T·k/E⌉ of them, its first in token order (the
  public model is dropless);
* the weights are random (``weight_groups``), the selection bias too.

float32 throughout with TF32 off, plain torch operations, layer by layer.
It imports nothing of the program and reads weights only through
``fetch(group)``, in the program's names and layouts (``nn.Linear`` weights
(out, in); experts (E, in, out); the router (d, E)).  ``quant`` (the
precision control) rounds every value the program holds in its own dtype:
both operands of every matrix product (the probabilities too), the
embedding rows, each projection's output, each sublayer's output and the
residual stream after each add, and the logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.references.moe_lm import (_fp32_products, _rms, _rounded_mm,
                                     _same, float_group)

EMBED_STD = 0.02      # token embedding
NORM_STD = 0.1        # RMSNorm scales, around the 1 of ``1 + scale``
BIAS_STD = 0.05       # the router's selection bias
QUERY_BLOCK = 1024    # queries a block of the attention


def _dims(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["kv_lora_rank"])


def _dense(i: int, cfg: dict) -> bool:
    return i < cfg["first_k_dense_replace"]


def weight_groups(cfg: dict) -> list[dict]:
    """Group 0 the embedding, 1 the LM head, 2 every RMSNorm scale and every
    router's selection bias (float32), then one group a layer; weights
    ``std · N(0, 1)`` in the served dtype, std 1/√fan_in."""
    d, H, dn, dr, dv, r = _dims(cfg)
    E, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs, ff = cfg["n_shared_experts"] * fe, cfg["intermediate_size"]
    Vp, dt = cfg["padded_vocab"], cfg["dtype"]
    fp32 = [("final_norm.scale", (d,), NORM_STD)]
    groups = [{"dtype": dt, "tensors": [("embedding", (Vp, d), EMBED_STD)]},
              {"dtype": dt, "tensors": [("lm_head.weight", (Vp, d),
                                         1 / math.sqrt(d))]},
              {"dtype": "float32", "tensors": fp32}]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        fp32 += [(p + "norm1.scale", (d,), NORM_STD),
                 (p + "norm2.scale", (d,), NORM_STD),
                 (p + "mixer.kv_norm.scale", (r,), NORM_STD)]
        t = [(p + "mixer.wq.weight", (H * (dn + dr), d), 1 / math.sqrt(d)),
             (p + "mixer.wkv_a.weight", (r + dr, d), 1 / math.sqrt(d)),
             (p + "mixer.wkv_b.weight", (H * (dn + dv), r), 1 / math.sqrt(r)),
             (p + "mixer.wo.weight", (d, H * dv), 1 / math.sqrt(H * dv))]
        if _dense(i, cfg):
            t += [(p + "mlp.w_up.weight", (ff, d), 1 / math.sqrt(d)),
                  (p + "mlp.w_gate.weight", (ff, d), 1 / math.sqrt(d)),
                  (p + "mlp.w_down.weight", (d, ff), 1 / math.sqrt(ff))]
        else:
            fp32.append((p + "moe.router_bias", (E,), BIAS_STD))
            t += [(p + "moe.w_router", (d, E), 1 / math.sqrt(d)),
                  (p + "moe.experts_up", (E, d, fe), 1 / math.sqrt(d)),
                  (p + "moe.experts_gate", (E, d, fe), 1 / math.sqrt(d)),
                  (p + "moe.experts_down", (E, fe, d), 1 / math.sqrt(fe)),
                  (p + "moe.shared.w_up.weight", (fs, d), 1 / math.sqrt(d)),
                  (p + "moe.shared.w_gate.weight", (fs, d),
                   1 / math.sqrt(d)),
                  (p + "moe.shared.w_down.weight", (d, fs),
                   1 / math.sqrt(fs))]
        groups.append({"dtype": dt, "tensors": t})
    return groups


def _rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat([-x2, x1], -1)


def _rope(x, theta: float):
    """x (B, L, H, r) at positions 0..L−1, as DeepSeek-V3's
    ``apply_rotary_pos_emb``: (r/2, 2) pairs de-interleaved, then
    x·cos + rotate_half(x)·sin, the frequencies θ^(−2i/r) repeated over
    the two halves."""
    L, r = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                       device=x.device) / r)
    freqs = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    emb = torch.cat([freqs, freqs], -1)[:, None, :]          # (L, 1, r)
    x = x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * emb.cos() + _rotate_half(x) * emb.sin()


def _attention(w, p, cfg, h, mm, q):
    """Causal latent attention of each row of h (B, L, d)."""
    B, L, _ = h.shape
    d, H, dn, dr, dv, r = _dims(cfg)
    qh = q(mm(h, w[p + "mixer.wq.weight"].T)).reshape(B, L, H, dn + dr)
    q_nope, q_pe = qh.split([dn, dr], -1)
    c, k_pe = q(mm(h, w[p + "mixer.wkv_a.weight"].T)).split([r, dr], -1)
    c = q(_rms(c, w[p + "mixer.kv_norm.scale"], cfg["rms_norm_eps"]))
    kv = q(mm(c, w[p + "mixer.wkv_b.weight"].T)).reshape(B, L, H, dn + dv)
    k_nope, v = kv.split([dn, dv], -1)
    k_pe = q(_rope(k_pe[:, :, None], cfg["rope_theta"]))
    qs = torch.cat([q_nope, q(_rope(q_pe, cfg["rope_theta"]))], -1)
    ks = torch.cat([k_nope, k_pe.expand(B, L, H, dr)], -1)
    qs, ks, v = qs.transpose(1, 2), ks.transpose(1, 2), v.transpose(1, 2)
    o = torch.empty(B, H, L, dv, device=h.device)
    pos = torch.arange(L, device=h.device)
    for s0 in range(0, L, QUERY_BLOCK):
        s1 = min(L, s0 + QUERY_BLOCK)
        s = mm(qs[:, :, s0:s1], ks[:, :, :s1].transpose(2, 3)) \
            / math.sqrt(dn + dr)
        seen = pos[None, :s1] <= pos[s0:s1, None]
        a = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
        del s
        o[:, :, s0:s1] = mm(a, v[:, :, :s1])
        del a
    o = q(o.transpose(1, 2).reshape(B, L, H * dv))
    return q(mm(o, w[p + "mixer.wo.weight"].T))


def _swiglu(h, up, gate, down, mm, q):
    """down(silu(h·gate) · h·up), weights (out, in), each product rounded."""
    u = q(mm(h, up.T))
    g = q(F.silu(q(mm(h, gate.T))))
    return q(mm(q(g * u), down.T))


def capacity(T: int, cfg: dict) -> int | None:
    """Tokens an expert takes from a wave of T tokens: ``capacity_multiple``
    times ⌈T·k/E⌉ (at least 1), or None (dropless) without one."""
    m = cfg.get("capacity_multiple")
    if m is None:
        return None
    return max(1, -(-T * cfg["num_experts_per_tok"]
                    // cfg["n_routed_experts"]) * m)


def _moe(w, p, cfg, h, mm, q, stats=None):
    """The routed and shared experts of a wave h (B, L, d): its B·L tokens
    routed together; each expert keeps its first ``capacity`` chosen tokens
    in that order and drops the rest."""
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(h, w[p + "moe.w_router"]))
    _, idx = torch.sort(scores + w[p + "moe.router_bias"], dim=-1,
                        descending=True, stable=True)
    idx = idx[:, :k]
    gates = scores.gather(1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]
    cap = capacity(h.shape[0], cfg)
    out = torch.zeros_like(h)
    for e in idx.unique().tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)   # in token order
        if cap is not None and len(tok) > cap:
            if stats is not None:
                stats["dropped"] = stats.get("dropped", 0) + len(tok) - cap
            tok, slot = tok[:cap], slot[:cap]
        y = _swiglu(h[tok], w[p + "moe.experts_up"][e].T,
                    w[p + "moe.experts_gate"][e].T,
                    w[p + "moe.experts_down"][e].T, mm, q)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + idx.numel()
    shared = _swiglu(h, w[p + "moe.shared.w_up.weight"],
                     w[p + "moe.shared.w_gate.weight"],
                     w[p + "moe.shared.w_down.weight"], mm, q)
    return q(q(out) + shared).reshape(shape)


def layer(w: dict, cfg: dict, i: int, x, quant=None,
          stats=None) -> torch.Tensor:
    """Layer ``i`` of a wave of equal-length prompts: x (B, L, d) → (B, L,
    d), float32.  ``w`` holds the layer's tensors and group 2 (norm scales,
    selection biases) in float32; ``stats`` (a dict) gathers the expert
    pairs chosen and dropped."""
    q = quant or _same
    mm, p, eps = _rounded_mm(q), f"layers.{i}.", cfg["rms_norm_eps"]
    with _fp32_products():
        x = q(x + _attention(w, p, cfg, _rms(x, w[p + "norm1.scale"], eps),
                             mm, q))
        h = q(_rms(x, w[p + "norm2.scale"], eps))
        if _dense(i, cfg):
            f = _swiglu(h, w[p + "mlp.w_up.weight"],
                        w[p + "mlp.w_gate.weight"],
                        w[p + "mlp.w_down.weight"], mm, q)
        else:
            f = _moe(w, p, cfg, h, mm, q, stats)
        return q(x + f)


def head(norms: dict, head_w, cfg: dict, x, quant=None) -> torch.Tensor:
    """Logits (n, vocab_size) of final states x (n, d): the final RMSNorm
    and the LM head, float32."""
    q = quant or _same
    with _fp32_products():
        h = _rms(x, norms["final_norm.scale"], cfg["rms_norm_eps"])
        return q(_rounded_mm(q)(h, head_w.T)[:, :cfg["vocab_size"]])


def forward(cfg: dict, fetch, ids, quant=None) -> torch.Tensor:
    """Every position's logits (B, L, vocab_size) of token ids (B, L): the
    whole forward, float32.  ``fetch(g)`` gives weight group g
    (``weight_groups``)."""
    q = quant or _same
    norms = float_group(fetch, 2)
    emb = fetch(0)["embedding"]
    x = q(emb[torch.as_tensor(ids, device=emb.device).long()].float())
    del emb
    for i in range(cfg["num_hidden_layers"]):
        w = float_group(fetch, 3 + i)
        w.update(norms)
        x = layer(w, cfg, i, x, quant)
        del w
    B, L, d = x.shape
    return head(norms, float_group(fetch, 1)["lm_head.weight"], cfg,
                x.reshape(B * L, d), quant).reshape(B, L, -1)


def last_logits(cfg: dict, fetch, prompts, quant=None) -> torch.Tensor:
    """(len(prompts), vocab_size) float32 logits of each prompt's last
    position, the whole forward, each prompt a wave of its own."""
    return torch.cat([forward(cfg, fetch, [pr], quant)[:, -1]
                      for pr in prompts])
