"""Conditional DiT denoiser ε_θ(x_t, t, y) — the stand-in for Stable
Diffusion: patchify → adaLN-zero transformer → unpatchify, conditioned on
a 512-d encoding vector (the CLIP-embedding slot of the OSCAR pipeline)
through adaLN modulation and a prepended conditioning token.  A learned
null embedding Ø implements classifier-free sampling (Ho & Salimans).

Layouts follow the JAX package's ``diffusion/dit.py`` so that its
parameters load through ``repro_torch.convert``: NHWC images, patch vectors
ordered (row-in-patch, col-in-patch, channel), QKV split as
(B, S, 3, heads, hd), the six block modulations in the order
``sa_shift, sa_scale, sa_gate, ml_shift, ml_scale, ml_gate``, the output
modulation as (shift, scale), and timestep features as [cos, sin].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.kernels.adaln_norm import ops as adaln_ops
from repro_torch.kernels.adaln_norm import ref as adaln_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.utils import lecun_init, normal_init, resolve_device


def timestep_embedding(t, dim: int, max_period: float = 10_000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    ang = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def patchify(x, p: int):
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(tok, p: int, H: int, W: int, C: int):
    B = tok.shape[0]
    x = tok.reshape(B, H // p, W // p, p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _dense(d_in: int, d_out: int, generator, device, *, bias: bool = True,
           zero: bool = False) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=bias, device=device)
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
        else:   # LeCun on the (in, out) matrix, stored transposed
            lin.weight.copy_(lecun_init((d_in, d_out), generator, device).T)
        if bias:
            lin.bias.zero_()
    return lin


def _kernel_attention(q, k, v):
    return fa_ops.flash_attention(q, k, v, causal=False)


def _plain_attention(q, k, v):
    return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False).transpose(1, 2)


class DiTBlock(nn.Module):
    def __init__(self, d: int, generator, device):
        super().__init__()
        self.wqkv = _dense(d, 3 * d, generator, device, bias=False)
        self.wo = _dense(d, d, generator, device, bias=False)
        self.w_up = _dense(d, 4 * d, generator, device)
        self.w_down = _dense(4 * d, d, generator, device)
        self.mod = _dense(d, 6 * d, generator, device, zero=True)  # adaLN-zero


class DiT(nn.Module):
    """ε-prediction network.  ``forward(x_t, t, y)``: x_t (B, H, W, C),
    t (B,) integer timesteps, y (B, cond_dim) encodings or ``None`` for the
    null embedding Ø.  Its parameters live on ``device``: the card unless
    the caller passes ``"cpu"``.

    The LayerNorm + modulation sites and the attention go through the
    kernel wrappers (``kernels/adaln_norm``, ``kernels/flash_attention``),
    which launch the hand-written kernels on CUDA tensors.  A model whose
    ``plain`` attribute is set runs the plain PyTorch versions instead, on
    any device: it is the reference the kernel path is held against."""

    def __init__(self, dc: DiffusionConfig, image_size: int, channels: int,
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, p = dc.d_model, dc.patch
        if d % dc.num_heads:
            raise ValueError(f"d_model={d} is not a multiple of "
                             f"num_heads={dc.num_heads}")
        self.dc = dc
        device = resolve_device(device)
        n_tok = (image_size // p) ** 2
        patch_dim = p * p * channels
        g = generator
        self.patch_in = _dense(patch_dim, d, g, device)
        self.pos = nn.Parameter(normal_init((n_tok, d), g, 0.02, device))
        self.t_mlp1 = _dense(d, d, g, device)
        self.t_mlp2 = _dense(d, d, g, device)
        self.y_proj = _dense(dc.cond_dim, d, g, device)
        self.null_y = nn.Parameter(normal_init((dc.cond_dim,), g, 0.5, device))
        self.out_mod = _dense(d, 2 * d, g, device, zero=True)
        self.patch_out = _dense(d, patch_dim, g, device, zero=True)
        # conditioning token: gives attention direct access to y
        self.cond_tok = _dense(dc.cond_dim, d, g, device)
        self.blocks = nn.ModuleList(DiTBlock(d, g, device)
                                    for _ in range(dc.num_layers))
        self.plain = False

    def forward(self, x_t, t, y=None):
        dc = self.dc
        if dc.bf16_act:
            raise NotImplementedError("bf16_act is not ported yet")
        norm = adaln_ref.adaln_norm if self.plain else adaln_ops.adaln_norm
        attend = _plain_attention if self.plain else _kernel_attention
        B, H, W, C = x_t.shape
        p, d, nh = dc.patch, dc.d_model, dc.num_heads
        tok = self.patch_in(patchify(x_t, p)) + self.pos

        c = self.t_mlp2(F.silu(self.t_mlp1(timestep_embedding(t, d))))
        if y is None:
            y = self.null_y.expand(B, dc.cond_dim)
        y = y.float()
        c = F.silu(c + self.y_proj(y))
        # prepend the conditioning token (sliced off before unpatchify)
        tok = torch.cat([self.cond_tok(y)[:, None], tok], dim=1)

        for blk in self.blocks:
            sa_shift, sa_scale, sa_gate, ml_shift, ml_scale, ml_gate = \
                blk.mod(c).chunk(6, dim=-1)
            h = norm(tok, sa_scale, sa_shift)
            qkv = blk.wqkv(h).view(B, -1, 3, nh, d // nh)
            o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            tok = tok + sa_gate[:, None] * blk.wo(o.reshape(B, -1, d))
            h = norm(tok, ml_scale, ml_shift)
            # the reference's gelu is the tanh form; torch defaults to erf
            h = blk.w_down(F.gelu(blk.w_up(h), approximate="tanh"))
            tok = tok + ml_gate[:, None] * h

        shift, scale = self.out_mod(c).chunk(2, dim=-1)
        tok = norm(tok[:, 1:], scale, shift)   # drop the conditioning token
        return unpatchify(self.patch_out(tok), p, H, W, C)

