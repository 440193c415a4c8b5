"""Procedural multi-domain image data with the paper's non-IID structure.

Stands in for NICO++/DomainNet/OpenImage: every image has a
*category* (foreground shape — the label) and a *domain* (background
palette + texture statistics).  The paper's **feature-distribution skew**
is reproduced exactly: each client owns a single domain of every category
(NICO++/DomainNet division, §V-b), 6 clients = 6 domains.

Images are deterministic functions of (seed, category, domain, instance):
category fixes a low-frequency foreground mask; domain fixes background
colour/texture; instances jitter phase/position/noise.  A model must use
the category shape (not the domain palette) to generalise across clients —
the same pressure the real benchmarks apply.

A numpy-only copy of the JAX package's ``data/federated.py`` against the
port's own ``DataConfig``: the same config gives bit-equal data.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.oscar import DataConfig


@dataclass
class FederatedData:
    # per-client training shards (feature-skew: client r == domain r)
    client_images: np.ndarray   # (R, n_client, H, W, C) in [-1, 1]
    client_labels: np.ndarray   # (R, n_client)
    client_domains: np.ndarray  # (R, n_client)
    # global test set (all domains mixed)
    test_images: np.ndarray
    test_labels: np.ndarray
    test_domains: np.ndarray
    num_categories: int
    num_domains: int
    # optional DM pre-training pool (disjoint instances; the "web data"
    # a pre-trained diffusion model was built from)
    pool_images: np.ndarray | None = None
    pool_labels: np.ndarray | None = None
    pool_domains: np.ndarray | None = None

    def client_test_set(self, r: int):
        """Domain-r test slice = the paper's 'client-r test set'."""
        m = self.test_domains == r
        return self.test_images[m], self.test_labels[m]


def _category_mask(rng: np.random.Generator, size: int) -> np.ndarray:
    """Low-frequency random foreground mask in [0,1]."""
    g = rng.normal(size=(4, 4))
    k = size // 4
    up = np.kron(g, np.ones((k, k)))
    # smooth with a small box filter
    pad = np.pad(up, 2, mode="wrap")
    sm = sum(pad[i:i + size, j:j + size] for i in range(5) for j in range(5)) / 25.0
    mask = (sm > np.quantile(sm, 0.6)).astype(np.float32)
    return mask


def _domain_style(rng: np.random.Generator):
    bg = rng.uniform(-0.9, 0.9, size=(3,))
    freq = rng.integers(1, 4)
    axis = rng.integers(0, 2)
    amp = rng.uniform(0.1, 0.35)
    tint = rng.uniform(-0.3, 0.3, size=(3,))
    return bg, int(freq), int(axis), amp, tint


def _render(cat_mask, style, fg_color, rng, size, distractor=None):
    """One image.  Deliberately hard: large positional jitter, flips,
    brightness/contrast jitter, a low-alpha distractor shape from another
    category, and strong pixel noise — so 30 images/category locally
    overfits (the paper's Local row is weak) and cross-domain transfer
    requires real shape recognition."""
    bg, freq, axis, amp, tint = style
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * freq * (yy if axis == 0 else xx) / size + phase)
    dy, dx = rng.integers(-4, 5, size=2)
    m = np.roll(np.roll(cat_mask, dy, 0), dx, 1)
    if rng.random() < 0.5:
        m = m[:, ::-1]
    m = m[..., None]
    fg = np.clip(fg_color + tint + rng.normal(scale=0.15, size=3), -1, 1)
    img = (1 - m) * (bg + amp * wave[..., None]) + m * fg
    if distractor is not None:
        ddy, ddx = rng.integers(-4, 5, size=2)
        dmask = np.roll(np.roll(distractor, ddy, 0), ddx, 1)[..., None]
        img = img * (1 - 0.35 * dmask) + 0.35 * dmask * rng.uniform(-1, 1, size=3)
    # brightness / contrast jitter
    img = img * rng.uniform(0.8, 1.2) + rng.uniform(-0.15, 0.15)
    img += rng.normal(scale=0.15, size=img.shape)
    return np.clip(img, -1.0, 1.0).astype(np.float32)


def make_federated_data(dc: DataConfig) -> FederatedData:
    rng = np.random.default_rng(dc.seed)
    C, D, size = dc.num_categories, dc.num_domains, dc.image_size
    cat_masks = [_category_mask(rng, size) for _ in range(C)]
    cat_colors = [rng.uniform(-1, 1, size=(3,)) for _ in range(C)]
    styles = [_domain_style(rng) for _ in range(D)]

    def block(n_per):
        imgs, labels, doms = [], [], []
        for d in range(D):
            for c in range(C):
                for _ in range(n_per):
                    dist = None
                    if rng.random() < 0.5:
                        dist = cat_masks[int(rng.integers(0, C))]
                    imgs.append(_render(cat_masks[c], styles[d],
                                        cat_colors[c], rng, size,
                                        distractor=dist))
                    labels.append(c)
                    doms.append(d)
        return (np.stack(imgs), np.array(labels, np.int32),
                np.array(doms, np.int32))

    tr_i, tr_l, tr_d = block(dc.train_per_cat_dom)
    te_i, te_l, te_d = block(dc.test_per_cat_dom)
    pool = (None, None, None)
    if dc.pretrain_pool_per_cat_dom:
        pool = block(dc.pretrain_pool_per_cat_dom)

    ci, cl, cd = partition_feature_skew(tr_i, tr_l, tr_d, D)
    return FederatedData(ci, cl, cd, te_i, te_l, te_d, C, D, *pool)


def partition_feature_skew(images, labels, domains, num_clients: int):
    """Paper §V-b: client r owns domain r for every category."""
    ci, cl, cd = [], [], []
    for r in range(num_clients):
        m = domains == r
        ci.append(images[m])
        cl.append(labels[m])
        cd.append(domains[m])
    n = min(len(x) for x in ci)
    return (np.stack([x[:n] for x in ci]), np.stack([x[:n] for x in cl]),
            np.stack([x[:n] for x in cd]))


def partition_label_skew(images, labels, num_clients: int, alpha: float = 0.5,
                         seed: int = 0):
    """Dirichlet label-skew partition (standard FL benchmark alternative)."""
    rng = np.random.default_rng(seed)
    C = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(C)]
    client_idx = [[] for _ in range(num_clients)]
    for c in range(C):
        rng.shuffle(idx_by_class[c])
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx_by_class[c])).astype(int)[:-1]
        for r, part in enumerate(np.split(idx_by_class[c], cuts)):
            client_idx[r].extend(part.tolist())
    return [np.array(sorted(ix), np.int64) for ix in client_idx]
