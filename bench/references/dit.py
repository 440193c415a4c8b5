"""Plain reference of the D_syn sampler: the conditional DiT denoiser
(patchify → adaLN-zero transformer blocks with a prepended conditioning
token → unpatchify), classifier-free guidance (paper Eq. 8) and the
ancestral/DDIM update (Eq. 9, η = 1), written with plain torch operations
in float32 and nothing else.

It imports nothing of the program.  It takes the weights the benchmark drew
(``weight_groups`` names them in the program's layout: ``nn.Linear``
weights are (out, in)), the encodings, and the wave's threefry key, and
works out x_T and every step's noise again with its own threefry copy.
Rows are independent: row b of a wave of B rows reads elements
``b·H·W·C ..`` of the wave's draws, so a sample of requests can be run
alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench.references import threefry

# adaLN-zero starts every block's modulation and the output layers at zero;
# the benchmark perturbs every weight by this much so attention and the
# modulations reach the output the check compares
PERTURB = 0.05


def weight_groups(cfg: dict) -> list[dict]:
    """The weights as the benchmark draws them: one float32 group, each
    tensor ``std · N(0, 1)``, std the initialiser's scale (LeCun 1/√fan_in
    for dense weights, 0 for biases and the adaLN-zero layers, 0.02 for
    ``pos``, 0.5 for ``null_y``) combined with ``PERTURB``."""
    d, p, C = cfg["d_model"], cfg["patch"], cfg["channels"]
    n_tok = (cfg["image_size"] // p) ** 2
    pd, cd = p * p * C, cfg["cond_dim"]

    def std(s0):
        return math.sqrt(s0 * s0 + PERTURB * PERTURB)

    t = []

    def dense(name, d_in, d_out, *, bias=True, zero=False):
        t.append((f"{name}.weight", (d_out, d_in),
                  std(0.0 if zero else 1.0 / math.sqrt(d_in))))
        if bias:
            t.append((f"{name}.bias", (d_out,), std(0.0)))

    dense("patch_in", pd, d)
    t.append(("pos", (n_tok, d), std(0.02)))
    dense("t_mlp1", d, d)
    dense("t_mlp2", d, d)
    dense("y_proj", cd, d)
    t.append(("null_y", (cd,), std(0.5)))
    dense("out_mod", d, 2 * d, zero=True)
    dense("patch_out", d, pd, zero=True)
    dense("cond_tok", cd, d)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        dense(f"{b}.wqkv", d, 3 * d, bias=False)
        dense(f"{b}.wo", d, d, bias=False)
        dense(f"{b}.w_up", d, 4 * d)
        dense(f"{b}.w_down", 4 * d, d)
        dense(f"{b}.mod", d, 6 * d, zero=True)
    return [{"dtype": "float32", "tensors": t}]


# -- the denoiser -----------------------------------------------------------

def _lin(w, name, x):
    y = x @ w[f"{name}.weight"].T
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def _modulated_norm(x, scale, shift, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * (1 + scale[:, None]) \
        + shift[:, None]


def denoiser(w, cfg: dict, x, t, y):
    """ε(x_t, t, y): x (B, H, W, C) images, t (B,) timesteps, y (B, cond)
    encodings.  float32 throughout."""
    B, H, W, C = x.shape
    p, d, nh = cfg["patch"], cfg["d_model"], cfg["num_heads"]
    hd = d // nh
    g = H // p
    tok = x.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, g * g, p * p * C)
    tok = _lin(w, "patch_in", tok) + w["pos"]
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = t[:, None].float() * freqs[None]
    temb = torch.cat([torch.cos(ang), torch.sin(ang)], -1)
    c = _lin(w, "t_mlp2", F.silu(_lin(w, "t_mlp1", temb)))
    c = F.silu(c + _lin(w, "y_proj", y))
    tok = torch.cat([_lin(w, "cond_tok", y)[:, None], tok], 1)
    S = tok.shape[1]
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        m = _lin(w, f"{b}.mod", c).chunk(6, -1)
        h = _modulated_norm(tok, m[1], m[0])
        qkv = (h @ w[f"{b}.wqkv.weight"].T).reshape(B, S, 3, nh, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        o = (att @ v).transpose(1, 2).reshape(B, S, d)
        tok = tok + m[2][:, None] * (o @ w[f"{b}.wo.weight"].T)
        h = _modulated_norm(tok, m[4], m[3])
        h = _lin(w, f"{b}.w_down",
                 F.gelu(_lin(w, f"{b}.w_up", h), approximate="tanh"))
        tok = tok + m[5][:, None] * h
    shift, scale = _lin(w, "out_mod", c).chunk(2, -1)
    tok = _lin(w, "patch_out", _modulated_norm(tok[:, 1:], scale, shift))
    return tok.reshape(B, g, g, p, p, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, H, W, C)


# -- the schedule and the respaced trajectory --------------------------------

def alpha_bar(T: int) -> np.ndarray:
    """The cosine schedule's ᾱ (Nichol & Dhariwal, s = 0.008), float32,
    with each β clipped to [0, 0.999]."""
    s = 0.008
    t = np.arange(T + 1, dtype=np.float32) / np.float32(T)
    f = np.cos((t + np.float32(s)) / np.float32(1 + s)
               * np.float32(math.pi / 2)).astype(np.float32) ** 2
    ab = f / f[0]
    betas = np.clip(1 - ab[1:] / ab[:-1], 0, 0.999).astype(np.float32)
    return np.cumprod(1.0 - betas, dtype=np.float32)


def respaced(T: int, n: int) -> np.ndarray:
    """The n visited timesteps, T−1 down to 0: ``linspace(T−1, 0, n)`` in
    float32 as a jitted sampler evaluates it (from 17 elements on, each
    ``1 − i/(n−1)`` rounded once), rounded, then made strictly
    decreasing."""
    if n == 1:
        lin = np.array([T - 1], np.float32)
    else:
        div = n - 1
        c = np.float32(1) / np.float32(div)
        i = np.arange(div)
        once = (1.0 - i * np.float64(c)).astype(np.float32)
        twice = np.float32(1) - i.astype(np.float32) * c
        frac = once if n >= 17 else twice
        lin = np.concatenate([(np.float64(np.float32(T - 1)) * frac)
                              .astype(np.float32), np.zeros(1, np.float32)])
    ts = np.round(lin).astype(np.int64)
    i = np.arange(len(ts))
    ts = np.minimum.accumulate(ts + i) - i
    return np.maximum(ts, len(ts) - 1 - i)


def sample_rows(w, cfg: dict, wave_key, row_offset: int, enc,
                guidance: float, steps: int, device) -> torch.Tensor:
    """The images that rows ``row_offset ..`` of a classifier-free wave
    drawn from ``wave_key`` come out as, conditioned on
    ``enc`` (n, cond), one row each: x_T from the first of two splits of
    the key, step i's noise from the chain of splits after it, each step
    ε̂ = (1+s)·ε(x, ȳ) − s·ε(x, Ø) and the ancestral update, the result
    clipped to [−1, 1]."""
    H, C = cfg["image_size"], cfg["channels"]
    n = len(enc)
    row = H * H * C
    shape = (n, H, H, C)
    key, k0 = threefry.split(np.asarray(wave_key, np.uint32))
    step_keys = []
    for _ in range(steps):
        key, kn = threefry.split(key)
        step_keys.append(kn)
    ab = alpha_bar(cfg["train_timesteps"])
    ts = respaced(cfg["train_timesteps"], steps)
    y = torch.as_tensor(np.asarray(enc, np.float32), device=device)
    y2 = torch.cat([y, w["null_y"].expand(n, -1)])
    x = threefry.normal(k0, shape, device, offset=row_offset * row)
    for i, t in enumerate(ts.tolist()):
        abt = torch.tensor(ab[t], device=device)
        abp = torch.tensor(ab[ts[i + 1]] if i + 1 < len(ts) else 1.0,
                           dtype=torch.float32, device=device)
        tt = torch.full((2 * n,), t, dtype=torch.int64, device=device)
        e2 = denoiser(w, cfg, torch.cat([x, x]), tt, y2)
        eps = (1.0 + guidance) * e2[:n] - guidance * e2[n:]
        x0 = torch.clamp((x - torch.sqrt(1 - abt) * eps) / torch.sqrt(abt),
                         -1.0, 1.0)
        var = (1 - abp) / (1 - abt) * (1 - abt / abp)
        sigma = torch.sqrt(torch.clamp(var, min=0.0))
        coef = torch.sqrt(torch.clamp(1 - abp - sigma ** 2, min=0.0))
        z = (threefry.normal(step_keys[i], shape, device,
                             offset=row_offset * row) if t > 0
             else torch.zeros(shape, device=device))
        x = torch.sqrt(abp) * x0 + coef * eps + sigma * z
    return torch.clamp(x, -1.0, 1.0)
