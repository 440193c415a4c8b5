"""Frozen foundation-model encoder — the BLIP→CLIP stand-in.

The paper's clients run ``y_cn = CLIP_text(BLIP(x_cn))`` (Eq. 6) with
FROZEN weights, zero-shot.  What OSCAR needs from this pipeline is a frozen
deterministic map image → R^512 whose geometry reflects semantic content.
It is a fixed-seed random feature extractor plus projection; its weights
come from ``np.random.default_rng(seed)``, so they equal the JAX package's
draw for draw.
"""
from __future__ import annotations

import numpy as np
import torch


class FrozenFM:
    """Deterministic frozen encoder: images (B,H,W,C) in [-1,1] -> (B,512),
    computed on the images' device."""

    def __init__(self, dim: int = 512, seed: int = 1234, patch: int = 4):
        self.dim = dim
        self.patch = patch
        self._rng = np.random.default_rng(seed)
        self._built = None

    def _build(self, H, W, C, feat_dim):
        p = self.patch
        pd = p * p * C
        w1 = self._rng.normal(size=(pd, 128)) / np.sqrt(pd)
        wo = self._rng.normal(size=(feat_dim, self.dim)) / np.sqrt(feat_dim)
        self._proj = (torch.as_tensor(w1, dtype=torch.float32),
                      torch.as_tensor(wo, dtype=torch.float32))
        self._built = (H, W, C, feat_dim)

    def _features(self, images):
        B, H, W, C = images.shape
        p = self.patch

        def pool(x, g):
            return x.reshape(B, g, H // g, g, W // g, C).mean((2, 4)).reshape(B, -1)

        f_pool4 = pool(images, 4)                            # 4×4 grid stats
        f_pool2 = pool(images, 2)
        dx = torch.diff(images, dim=2, append=images[:, :, -1:])
        dy = torch.diff(images, dim=1, append=images[:, -1:])
        edge = torch.sqrt(dx ** 2 + dy ** 2 + 1e-8).mean(-1, keepdim=True)
        f_edge = edge.reshape(B, 4, H // 4, 4, W // 4, 1).mean((2, 4)).reshape(B, -1)
        bins = torch.linspace(-1, 1, 5, device=images.device)
        f_hist = torch.softmax(-((images[..., None] - bins) ** 2) / 0.125,
                               dim=-1).mean((1, 2)).reshape(B, -1)
        small = images.reshape(B, 8, H // 8, 8, W // 8, C).mean((2, 4)).reshape(B, -1)
        x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, -1, p * p * C)
        return [f_pool4, f_pool2, f_edge, f_hist, small], x

    def __call__(self, images) -> torch.Tensor:
        images = torch.as_tensor(images, dtype=torch.float32)
        B, H, W, C = images.shape
        # first pass builds projections once the feature dim is known
        feats, xpatch = self._features(images)
        if self._built is None or self._built[:3] != (H, W, C):
            base = sum(f.shape[-1] for f in feats)
            self._build(H, W, C, base + 128)
        w1, wo = (w.to(images.device) for w in self._proj)
        f_rand = torch.tanh(xpatch @ w1).mean(1)
        z = torch.cat(feats + [f_rand], dim=-1) @ wo   # (B, 512)
        z = z - z.mean(-1, keepdim=True)
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


def category_encodings(fm: FrozenFM, images, labels, num_categories: int):
    """Eq. 6 + Eq. 7: encode every image, mean-pool per category.

    Returns (ȳ (C, 512), present (C,) bool) on the images' device — ȳ_c is
    zero for absent categories.  ȳ is exactly what a client uploads."""
    z = fm(images)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=z.device)
    # per-category sums as a one-hot (C, B) by (B, 512) product in fp32
    # (TF32 off): a GEMM adds each output in an order fixed by its shape,
    # so one input gives the same bits in every process.  index_add_ on
    # the card adds with float atomics, in whatever order they land.
    onehot = (labels[None, :] == torch.arange(
        num_categories, device=z.device)[:, None]).to(torch.float32)
    out = onehot @ z
    cnt = onehot.sum(dim=1)
    present = cnt > 0
    mean = out / torch.clamp(cnt[:, None], min=1.0)
    # re-project the mean onto the unit sphere: the DM is conditioned on
    # unit-norm encodings (CLIP convention), and a mean of unit vectors is
    # shorter — without this the server conditions out-of-distribution.
    mean = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + 1e-6)
    mean = torch.where(present[:, None], mean, torch.zeros_like(mean))
    return mean, present
