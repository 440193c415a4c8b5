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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.convert import dit_state_from_jax
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


def _dense(d_in: int, d_out: int, device, *, bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` allocated, not drawn: ``init_dit`` fills it."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                              device=device)


def bf16_dense(lin: nn.Linear, x):
    """``lin(x)`` with bf16 operands and fp32 accumulation, the fp32 bias
    added after the product: the reference's ``_dense_act(..., bf16=True)``
    (``dot_general`` with ``preferred_element_type=float32``).  On the card
    one ``torch.mm(..., out_dtype=float32)`` on the tensor cores; on the CPU,
    which has no such GEMM, both operands rounded to bf16 and multiplied in
    fp32, the same function (a product of two bf16 values is exact in
    fp32).  Counts its calls in ``bf16_dense.calls``."""
    bf16_dense.calls += 1
    xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    wb = lin.weight.to(torch.bfloat16).T
    if x.is_cuda:
        y = torch.mm(xb, wb, out_dtype=torch.float32)
    else:
        y = xb.float() @ wb.float()
    if lin.bias is not None:
        y = y + lin.bias
    return y.view(*x.shape[:-1], -1)


bf16_dense.calls = 0


def _kernel_attention(q, k, v):
    return fa_ops.flash_attention(q, k, v, causal=False)


def _plain_attention(q, k, v):
    return fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False).transpose(1, 2)


class DiTBlock(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.wqkv = _dense(d, 3 * d, device, bias=False)
        self.wo = _dense(d, d, device, bias=False)
        self.w_up = _dense(d, 4 * d, device)
        self.w_down = _dense(4 * d, d, device)
        self.mod = _dense(d, 6 * d, device)   # adaLN-zero


class DiT(nn.Module):
    """ε-prediction network.  ``forward(x_t, t, y)``: x_t (B, H, W, C),
    t (B,) integer timesteps, y (B, cond_dim) encodings or ``None`` for the
    null embedding Ø.  Its parameters live on ``device``: the card unless
    the caller passes ``"cpu"``.

    The LayerNorm + modulation sites and the attention go through the
    kernel wrappers (``kernels/adaln_norm``, ``kernels/flash_attention``),
    which launch the hand-written kernels on CUDA tensors; with
    ``dc.bf16_act`` its QKV, output and MLP GEMMs take bf16 operands with
    fp32 accumulation (``bf16_dense``), as the reference's fused path does
    under the flag.  A model whose
    ``plain`` attribute is set runs the plain PyTorch versions instead, on
    any device: it is the reference the kernel path is held against.

    The constructor allocates the parameters and draws nothing:
    ``init_dit`` draws the reference's initial weights from a key, and
    ``dit_from_tree`` loads a reference-layout tree (a checkpoint, or
    ``repro_torch.convert``'s input)."""

    def __init__(self, dc: DiffusionConfig, image_size: int, channels: int,
                 *, device=None):
        super().__init__()
        d, p = dc.d_model, dc.patch
        if d % dc.num_heads:
            raise ValueError(f"d_model={d} is not a multiple of "
                             f"num_heads={dc.num_heads}")
        self.dc = dc
        device = resolve_device(device)
        n_tok = (image_size // p) ** 2
        patch_dim = p * p * channels
        self.patch_in = _dense(patch_dim, d, device)
        self.pos = nn.Parameter(torch.empty((n_tok, d), device=device))
        self.t_mlp1 = _dense(d, d, device)
        self.t_mlp2 = _dense(d, d, device)
        self.y_proj = _dense(dc.cond_dim, d, device)
        self.null_y = nn.Parameter(torch.empty((dc.cond_dim,), device=device))
        self.out_mod = _dense(d, 2 * d, device)
        self.patch_out = _dense(d, patch_dim, device)
        # conditioning token: gives attention direct access to y
        self.cond_tok = _dense(dc.cond_dim, d, device)
        self.blocks = nn.ModuleList(DiTBlock(d, device)
                                    for _ in range(dc.num_layers))
        self.plain = False

    def forward(self, x_t, t, y=None):
        dc = self.dc
        norm = adaln_ref.adaln_norm if self.plain else adaln_ops.adaln_norm
        attend = _plain_attention if self.plain else _kernel_attention
        # bf16_act acts on the kernel path only, as on the reference's fused
        # path: the QKV, output and MLP GEMMs in bf16 with fp32 accumulation
        if dc.bf16_act and not self.plain:
            dense = bf16_dense
        else:
            def dense(lin, v):
                return lin(v)
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
            qkv = dense(blk.wqkv, h).view(B, -1, 3, nh, d // nh)
            o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            tok = tok + sa_gate[:, None] * dense(blk.wo, o.reshape(B, -1, d))
            h = norm(tok, ml_scale, ml_shift)
            # the reference's gelu is the tanh form; torch defaults to erf
            h = dense(blk.w_down, F.gelu(dense(blk.w_up, h),
                                         approximate="tanh"))
            tok = tok + ml_gate[:, None] * h

        shift, scale = self.out_mod(c).chunk(2, dim=-1)
        tok = norm(tok[:, 1:], scale, shift)   # drop the conditioning token
        return unpatchify(self.patch_out(tok), p, H, W, C)


def _dense_tree(key, d_in: int, d_out: int, *, bias: bool = True,
                zero: bool = False) -> dict:
    w = (torch.zeros((d_in, d_out)) if zero
         else lecun_init(key, (d_in, d_out)))
    return {"w": w, "b": torch.zeros((d_out,))} if bias else {"w": w}


def init_dit_tree(key, dc: DiffusionConfig, image_size: int,
                  channels: int) -> dict:
    """The reference's ``init_dit(key, ...)`` tree, drawn from the same
    keys on the CPU: ``ks = split(key, 8 + 6·L)``, block i from
    ``ks[8 + 6i : 14 + 6i]``, ``cond_tok`` from ``fold_in(key, 99)``; the
    zero-initialised leaves ignore their keys.  Dense ``w`` is (in, out)."""
    d, p = dc.d_model, dc.patch
    n_tok = (image_size // p) ** 2
    patch_dim = p * p * channels
    key = np.asarray(key, np.uint32)
    ks = prng.split(key, 8 + 6 * dc.num_layers)
    tree = {
        "patch_in": _dense_tree(ks[0], patch_dim, d),
        "pos": normal_init(ks[1], (n_tok, d), 0.02),
        "t_mlp1": _dense_tree(ks[2], d, d),
        "t_mlp2": _dense_tree(ks[3], d, d),
        "y_proj": _dense_tree(ks[4], dc.cond_dim, d),
        "null_y": normal_init(ks[5], (dc.cond_dim,), 0.5),
        "out_mod": _dense_tree(ks[6], d, 2 * d, zero=True),
        "patch_out": _dense_tree(ks[7], d, patch_dim, zero=True),
        "cond_tok": _dense_tree(prng.fold_in(key, 99), dc.cond_dim, d),
        "blocks": [],
    }
    for i in range(dc.num_layers):
        k6 = ks[8 + 6 * i: 14 + 6 * i]
        tree["blocks"].append({
            "wqkv": _dense_tree(k6[0], d, 3 * d, bias=False),
            "wo": _dense_tree(k6[1], d, d, bias=False),
            "w_up": _dense_tree(k6[2], d, 4 * d),
            "w_down": _dense_tree(k6[3], 4 * d, d),
            "mod": _dense_tree(k6[4], d, 6 * d, zero=True),   # adaLN-zero
        })
    return tree


def dit_from_tree(tree, dc: DiffusionConfig, image_size: int,
                  channels: int, *, device=None) -> DiT:
    """A ``DiT`` holding the reference-layout ``tree`` (numpy arrays or CPU
    tensors), on ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    model = DiT(dc, image_size, channels, device="meta")
    model.load_state_dict(dit_state_from_jax(tree), assign=True)
    return model.to(device)


def init_dit(key, dc: DiffusionConfig, image_size: int, channels: int, *,
             device=None) -> DiT:
    """The DiT the reference's ``init_dit(key, ...)`` initialises, drawn on
    the CPU and moved to ``device``: the bits depend on the key alone."""
    return dit_from_tree(init_dit_tree(key, dc, image_size, channels), dc,
                         image_size, channels, device=device)
