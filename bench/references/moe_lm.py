"""Plain reference of a decoder-only MoE language model's prefill (the
OLMoE family): token embedding; per layer a pre-norm causal multi-head
attention with per-head RMS qk-norm and rotary positions, then a pre-norm
FFN of sparse SwiGLU experts (softmax router, top-k with the lower expert
index first among equal probabilities, gates renormalised over the k; the
tokens of a wave routed together, each expert taking at most its
``capacity`` of them in token order, dropless without a
``capacity_multiple``); a final RMSNorm and the LM head.

float32 throughout with TF32 off, plain torch operations, layer by layer.  It imports nothing of the program and
reads weights only through ``fetch(group)``, which returns a group of the
tensors the benchmark draws (``weight_groups``) by name, in the program's
layout (``nn.Linear`` weights (out, in); experts (E, in, out)).  RMSNorm
scales use the ``1 + scale`` convention.

``quant`` (the precision control) rounds every value the program holds in
its own dtype: both operands of every matrix product, the embedding rows,
each sublayer's output, the residual stream after each add, and the
logits.  Products still accumulate in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EMBED_STD = 0.02      # token embedding
NORM_STD = 0.1        # RMSNorm scales, around the 1 of ``1 + scale``


def weight_groups(cfg: dict) -> list[dict]:
    """Group 0 the embedding, 1 the LM head, 2 every RMSNorm scale (float32),
    then one group a layer; weights ``std · N(0, 1)`` in the served dtype,
    std 1/√fan_in."""
    d, hd, H, Hkv = (cfg["d_model"], cfg["head_dim"], cfg["num_heads"],
                     cfg["num_kv_heads"])
    E, fe, Vp = cfg["num_experts"], cfg["d_ff_expert"], cfg["padded_vocab"]
    dt = cfg["dtype"]
    norms = [("final_norm.scale", (d,), NORM_STD)]
    groups = [{"dtype": dt, "tensors": [("embedding", (Vp, d), EMBED_STD)]},
              {"dtype": dt, "tensors": [("lm_head.weight", (Vp, d),
                                         1 / math.sqrt(d))]},
              {"dtype": "float32", "tensors": norms}]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        norms += [(p + "norm1.scale", (d,), NORM_STD),
                  (p + "norm2.scale", (d,), NORM_STD)]
        if cfg["qk_norm"]:
            norms += [(p + "mixer.q_norm.scale", (hd,), NORM_STD),
                      (p + "mixer.k_norm.scale", (hd,), NORM_STD)]
        groups.append({"dtype": dt, "tensors": [
            (p + "mixer.wq.weight", (H * hd, d), 1 / math.sqrt(d)),
            (p + "mixer.wk.weight", (Hkv * hd, d), 1 / math.sqrt(d)),
            (p + "mixer.wv.weight", (Hkv * hd, d), 1 / math.sqrt(d)),
            (p + "mixer.wo.weight", (d, H * hd), 1 / math.sqrt(H * hd)),
            (p + "moe.w_router", (d, E), 1 / math.sqrt(d)),
            (p + "moe.experts_up", (E, d, fe), 1 / math.sqrt(d)),
            (p + "moe.experts_gate", (E, d, fe), 1 / math.sqrt(d)),
            (p + "moe.experts_down", (E, fe, d), 1 / math.sqrt(fe))]})
    return groups


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1 + scale)


def _rope(x, theta):
    """x (B, L, H, hd): rotate the two halves by position · θ^(−2i/hd)."""
    L, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None,
                                                                 None] * freqs
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], -1)


def _same(t):
    return t


def _attention(w, p, cfg, h, mm, q):
    """Causal self-attention of each row of h (B, L, d)."""
    B, L = h.shape[:2]
    H, Hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    qh = mm(h, w[p + "mixer.wq.weight"].T).reshape(B, L, H, hd)
    k = mm(h, w[p + "mixer.wk.weight"].T).reshape(B, L, Hkv, hd)
    v = mm(h, w[p + "mixer.wv.weight"].T).reshape(B, L, Hkv, hd)
    if cfg["qk_norm"]:
        qh = _rms(qh, w[p + "mixer.q_norm.scale"], cfg["norm_eps"])
        k = _rms(k, w[p + "mixer.k_norm.scale"], cfg["norm_eps"])
    qh, k = _rope(qh, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    rep = H // Hkv
    k = k.repeat_interleave(rep, 2)
    v = v.repeat_interleave(rep, 2)
    s = mm(qh.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    del s
    o = mm(a, v.transpose(1, 2)).transpose(1, 2).reshape(B, L, H * hd)
    return q(mm(o, w[p + "mixer.wo.weight"].T))


def capacity(T: int, cfg: dict) -> int | None:
    """Tokens an expert takes from a wave of T tokens: the configuration's
    ``capacity_multiple`` times the mean, ⌈T·k/E⌉ (at least 1), or None
    (dropless) without one."""
    m = cfg.get("capacity_multiple")
    if m is None:
        return None
    return max(1, -(-T * cfg["top_k"] // cfg["num_experts"]) * m)


def _moe(w, p, cfg, h, mm, q, stats=None):
    """The expert FFN of a wave h (B, L, d): its B·L tokens routed
    together; each expert keeps its first ``capacity`` chosen tokens in
    that order and drops the rest."""
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    probs = torch.softmax(mm(h, w[p + "moe.w_router"]), -1)
    k = cfg["top_k"]
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    cap = capacity(h.shape[0], cfg)
    out = torch.zeros_like(h)
    for e in idx.unique().tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)   # in token order
        if cap is not None and len(tok) > cap:
            if stats is not None:
                stats["dropped"] = stats.get("dropped", 0) + len(tok) - cap
            tok, slot = tok[:cap], slot[:cap]
        x = h[tok]
        up = mm(x, w[p + "moe.experts_up"][e])
        gate = F.silu(mm(x, w[p + "moe.experts_gate"][e]))
        y = mm(gate * up, w[p + "moe.experts_down"][e])
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + idx.numel()
    return q(out.reshape(shape))


@contextlib.contextmanager
def _fp32_products():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rounded_mm(q):
    def mm(a, b):
        return q(a) @ q(b)
    return mm


def layer(w: dict, cfg: dict, i: int, x, quant=None,
          stats=None) -> torch.Tensor:
    """Layer ``i`` of a wave of equal-length prompts: x (B, L, d) → (B, L,
    d), float32.  ``w`` holds the layer's tensors and the RMSNorm scales in
    float32; ``stats`` (a dict) gathers the expert pairs chosen and
    dropped."""
    q = quant or _same
    mm, p, eps = _rounded_mm(q), f"layers.{i}.", cfg["norm_eps"]
    with _fp32_products():
        x = q(x + _attention(w, p, cfg, _rms(x, w[p + "norm1.scale"], eps),
                             mm, q))
        return q(x + _moe(w, p, cfg, _rms(x, w[p + "norm2.scale"], eps),
                          mm, q, stats))


def head(norms: dict, head_w, cfg: dict, x, quant=None) -> torch.Tensor:
    """Logits (n, vocab_size) of final states x (n, d): the final RMSNorm
    and the LM head, float32."""
    q = quant or _same
    with _fp32_products():
        h = _rms(x, norms["final_norm.scale"], cfg["norm_eps"])
        return q(_rounded_mm(q)(h, head_w.T)[:, :cfg["vocab_size"]])


def float_group(fetch, g: int) -> dict:
    return {n: t.float() for n, t in fetch(g).items()}


def last_logits(cfg: dict, fetch, prompts, quant=None) -> torch.Tensor:
    """(len(prompts), vocab_size) float32 logits of each prompt's last
    position, the whole forward, each prompt a wave of its own.
    ``fetch(g)`` gives weight group g (``weight_groups``); ``quant`` as in
    the module's docstring."""
    q = quant or _same
    norms = float_group(fetch, 2)
    emb = fetch(0)["embedding"]
    xs = [q(emb[torch.as_tensor(pr, device=emb.device).long()].float())[None]
          for pr in prompts]
    del emb
    for i in range(cfg["num_layers"]):
        w = float_group(fetch, 3 + i)
        w.update(norms)
        xs = [layer(w, cfg, i, x, quant) for x in xs]
        del w
    return head(norms, float_group(fetch, 1)["lm_head.weight"], cfg,
                torch.stack([x[0, -1] for x in xs]), quant)
