"""Classifier zoo of the OSCAR global model (paper Tables I and II).

The JAX package's ``models/classifiers.py`` as ``nn.Module``s: 16×16
analogues of ResNet-18/50/101, VGG-16, DenseNet-121 and ViT-B/16, with
GroupNorm in place of BatchNorm.  Each module takes NHWC images, as the
reference does, and runs NCHW inside (``F.conv2d`` and ``F.group_norm``);
``init_classifier`` draws their initial weights from a threefry key as
the reference's does, and a reference tree loads through
``repro_torch.convert.classifier_state_from_jax``.  The reference runs
these outside any Pallas kernel, so the port leaves them to PyTorch's
library operators.

Where a literal port would compute another function:

* the reference's convolutions pad ``"SAME"`` the XLA way: total padding
  ``max((ceil(n/s) − 1)·s + k − n, 0)``, the smaller half before.  A 3×3
  stride-2 convolution on an even input pads (0, 1), not PyTorch's (1, 1);
* GroupNorm takes ``g = min(4, C)`` groups, stepped down until g divides C;
* VGG flattens its last feature map in NHWC order;
* the ViT flattens patches in (row, column, channel) order, normalises with
  eps 1e-6 and uses the tanh form of gelu (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.convert import classifier_state_from_jax
from repro_torch.utils import lecun_init, normal_init, resolve_device


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class _Conv(nn.Module):
    """Bias-free convolution with XLA's ``"SAME"`` padding, on NCHW."""

    def __init__(self, k: int, cin: int, cout: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, k, k),
                                               device=device))

    def forward(self, x, stride: int = 1):
        k = self.weight.shape[-1]
        (t, b), (l, r) = (_same_pads(n, k, stride) for n in x.shape[-2:])
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, stride=stride)


def _gn(ch: int, device) -> nn.GroupNorm:
    g = min(4, ch)
    while ch % g:
        g -= 1
    return nn.GroupNorm(g, ch, eps=1e-5, device=device)


def _fc(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# ResNet family
# ---------------------------------------------------------------------------

_RESNETS = {
    # name: (block kind, blocks per stage, widths)
    "resnet18": ("basic", (2, 2, 2), (16, 32, 64)),
    "resnet50": ("bottleneck", (2, 3, 4), (32, 64, 128)),
    "resnet101": ("bottleneck", (3, 4, 10), (32, 64, 128)),
}


class _Block(nn.Module):
    """A basic (two 3×3) or bottleneck (1×1, 3×3, 1×1) residual block; the
    stride sits on the first 3×3 convolution."""

    def __init__(self, kind: str, cin: int, cout: int, stride: int, device):
        super().__init__()
        d = device
        self.stride = stride
        if kind == "basic":
            widths = [(3, cin, cout), (3, cout, cout)]
            self.strided = 0
        else:
            mid = cout // 4
            widths = [(1, cin, mid), (3, mid, mid), (1, mid, cout)]
            self.strided = 1
        for i, (k, a, b) in enumerate(widths, 1):
            setattr(self, f"c{i}", _Conv(k, a, b, d))
            setattr(self, f"n{i}", _gn(b, d))
        self.depth = len(widths)
        self.proj = (_Conv(1, cin, cout, d)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        h = x
        for i in range(self.depth):
            conv = getattr(self, f"c{i + 1}")
            h = getattr(self, f"n{i + 1}")(
                conv(h, self.stride if i == self.strided else 1))
            if i + 1 < self.depth:
                h = F.relu(h)
        sc = self.proj(x, self.stride) if self.proj is not None else x
        return F.relu(h + sc)


class ResNet(nn.Module):
    def __init__(self, name: str, num_classes: int, in_ch: int, device):
        super().__init__()
        kind, reps, widths = _RESNETS[name]
        d = device
        self.stem = _Conv(3, in_ch, widths[0], d)
        self.stem_n = _gn(widths[0], d)
        blocks, cin = [], widths[0]
        for s, (rep, w) in enumerate(zip(reps, widths)):
            for b in range(rep):
                blocks.append(_Block(kind, cin, w,
                                     2 if (b == 0 and s > 0) else 1, d))
                cin = w
        self.blocks = nn.ModuleList(blocks)
        self.fc = _fc(cin, num_classes, d)

    def forward(self, x):
        h = F.relu(self.stem_n(self.stem(_nchw(x))))
        for blk in self.blocks:
            h = blk(h)
        return self.fc(h.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

_VGG_CFG = [(16, 2), (32, 2), (64, 3)]


class _ConvNorm(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, norm_ch: int, device):
        super().__init__()
        self.c = _Conv(k, cin, cout, device)
        self.n = _gn(norm_ch, device)


class VGG(nn.Module):
    def __init__(self, num_classes: int, in_ch: int, device):
        super().__init__()
        layers, cin = [], in_ch
        for w, rep in _VGG_CFG:
            for _ in range(rep):
                layers.append(_ConvNorm(3, cin, w, w, device))
                cin = w
        self.layers = nn.ModuleList(layers)
        self.fc1 = _fc(cin * 2 * 2, 128, device)
        self.fc2 = _fc(128, num_classes, device)

    def forward(self, x):
        h, i = _nchw(x), 0
        for _, rep in _VGG_CFG:
            for _ in range(rep):
                layer = self.layers[i]
                h = F.relu(layer.n(layer.c(h)))
                i += 1
            h = F.max_pool2d(h, 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC order
        return self.fc2(F.relu(self.fc1(h)))


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------

class DenseNet(nn.Module):
    def __init__(self, num_classes: int, in_ch: int, device,
                 growth: int = 8, blocks=(4, 4, 4)):
        super().__init__()
        d = device
        self.stem = _Conv(3, in_ch, 2 * growth, d)
        ch = 2 * growth
        dense, trans = [], []
        for bi, nl in enumerate(blocks):
            layers = []
            for _ in range(nl):
                layers.append(_ConvNorm(3, ch, growth, ch, d))
                ch += growth
            dense.append(nn.ModuleList(layers))
            if bi < len(blocks) - 1:
                trans.append(_ConvNorm(1, ch, ch // 2, ch, d))
                ch //= 2
        self.dense = nn.ModuleList(dense)
        self.trans = nn.ModuleList(trans)
        self.final_n = _gn(ch, d)
        self.fc = _fc(ch, num_classes, d)

    def forward(self, x):
        h = self.stem(_nchw(x))
        for bi, layers in enumerate(self.dense):
            for layer in layers:
                h = torch.cat([h, layer.c(F.relu(layer.n(h)))], dim=1)
            if bi < len(self.trans):
                t = self.trans[bi]
                h = F.avg_pool2d(t.c(F.relu(t.n(h))), 2, 2)
        h = F.relu(self.final_n(h))
        return self.fc(h.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

class _ViTBlock(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.qkv = _fc(d, 3 * d, device)
        self.proj = _fc(d, d, device)
        self.up = _fc(d, 4 * d, device)
        self.down = _fc(4 * d, d, device)
        self.n1 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.n2 = nn.LayerNorm(d, eps=1e-6, device=device)


class ViT(nn.Module):
    def __init__(self, num_classes: int, in_ch: int, device, d: int = 96,
                 layers: int = 4, heads: int = 4, patch: int = 4):
        super().__init__()
        self.d, self.heads, self.p = d, heads, patch
        self.patch = _fc(patch * patch * in_ch, d, device)
        self.pos = nn.Parameter(torch.empty((1 + (16 // patch) ** 2, d),
                                            device=device))
        self.cls = nn.Parameter(torch.empty((d,), device=device))
        self.blocks = nn.ModuleList(_ViTBlock(d, device)
                                    for _ in range(layers))
        self.fc = _fc(d, num_classes, device)

    def forward(self, x):
        d, heads, p = self.d, self.heads, self.p
        B, H, W, C = x.shape
        t = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        t = self.patch(t.reshape(B, -1, p * p * C))
        t = torch.cat([self.cls.expand(B, 1, d), t], dim=1) + self.pos
        hd = d // heads
        for blk in self.blocks:
            qkv = blk.qkv(blk.n1(t)).view(B, -1, 3, heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                              * hd ** -0.5, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, -1, d)
            t = t + blk.proj(o)
            t = t + blk.down(F.gelu(blk.up(blk.n2(t)), approximate="tanh"))
        return self.fc(t[:, 0])


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

CLASSIFIERS = ["resnet18", "vgg16", "resnet50", "resnet101", "densenet121",
               "vit_b16"]


def classifier_module(name: str, num_classes: int, in_ch: int = 3, *,
                      device=None) -> nn.Module:
    """The classifier ``name`` with its parameters allocated on ``device``
    and not drawn: the module ``init_classifier`` fills, or a reference
    tree loads into (``repro_torch.convert.classifier_state_from_jax``)."""
    device = resolve_device(device)
    if name in _RESNETS:
        return ResNet(name, num_classes, in_ch, device)
    if name == "vgg16":
        return VGG(num_classes, in_ch, device)
    if name == "densenet121":
        return DenseNet(num_classes, in_ch, device)
    if name == "vit_b16":
        return ViT(num_classes, in_ch, device)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# initial weights from a key, as the reference's init_classifier draws them
# ---------------------------------------------------------------------------

def _conv_tree(key, k: int, cin: int, cout: int) -> dict:
    # the reference divides by sqrt(fan_in) here (lecun_init multiplies)
    w = prng.truncated_normal(key, -2.0, 2.0, (k, k, cin, cout))
    return {"w": w / float(np.float32(math.sqrt(k * k * cin)))}


def _gn_tree(ch: int) -> dict:
    return {"scale": torch.ones((ch,)), "bias": torch.zeros((ch,))}


def _fc_tree(key, d_in: int, d_out: int) -> dict:
    return {"w": lecun_init(key, (d_in, d_out)), "b": torch.zeros((d_out,))}


def _block_tree(key, kind: str, cin: int, cout: int, stride: int) -> dict:
    if kind == "basic":
        widths = [(3, cin, cout), (3, cout, cout)]
    else:
        mid = cout // 4
        widths = [(1, cin, mid), (3, mid, mid), (1, mid, cout)]
    ks = prng.split(key, 2 * len(widths) + 1)
    tree = {}
    for i, (k, a, b) in enumerate(widths):
        tree[f"c{i + 1}"] = _conv_tree(ks[2 * i], k, a, b)
        tree[f"n{i + 1}"] = _gn_tree(b)
    if stride != 1 or cin != cout:
        tree["proj"] = _conv_tree(ks[-1], 1, cin, cout)
    return tree


def _resnet_tree(key, name: str, num_classes: int, in_ch: int) -> dict:
    kind, reps, widths = _RESNETS[name]
    layout, cin = [], widths[0]
    for s, (rep, w) in enumerate(zip(reps, widths)):
        for b in range(rep):
            layout.append((cin, w, 2 if (b == 0 and s > 0) else 1))
            cin = w
    ks = prng.split(key, 3)
    bk = prng.split(ks[2], len(layout))
    return {"stem": _conv_tree(ks[0], 3, in_ch, widths[0]),
            "stem_n": _gn_tree(widths[0]),
            "blocks": [_block_tree(bk[i], kind, *lay)
                       for i, lay in enumerate(layout)],
            "fc": _fc_tree(prng.fold_in(key, 7), cin, num_classes)}


def _vgg_tree(key, num_classes: int, in_ch: int) -> dict:
    layers, cin = [], in_ch
    for w, rep in _VGG_CFG:
        for _ in range(rep):
            key, k1, _ = prng.split(key, 3)
            layers.append({"c": _conv_tree(k1, 3, cin, w), "n": _gn_tree(w)})
            cin = w
    _, k1, k2 = prng.split(key, 3)
    return {"layers": layers, "fc1": _fc_tree(k1, cin * 2 * 2, 128),
            "fc2": _fc_tree(k2, 128, num_classes)}


def _densenet_tree(key, num_classes: int, in_ch: int, growth: int = 8,
                   blocks=(4, 4, 4)) -> dict:
    key, k1 = prng.split(key)
    tree = {"stem": _conv_tree(k1, 3, in_ch, 2 * growth), "dense": [],
            "trans": []}
    ch = 2 * growth
    for bi, nl in enumerate(blocks):
        layers = []
        for _ in range(nl):
            key, _, k2 = prng.split(key, 3)
            layers.append({"n": _gn_tree(ch), "c": _conv_tree(k2, 3, ch,
                                                              growth)})
            ch += growth
        tree["dense"].append(layers)
        if bi < len(blocks) - 1:
            key, _, k2 = prng.split(key, 3)
            tree["trans"].append({"n": _gn_tree(ch),
                                  "c": _conv_tree(k2, 1, ch, ch // 2)})
            ch //= 2
    _, _, k2 = prng.split(key, 3)
    tree["final_n"] = _gn_tree(ch)
    tree["fc"] = _fc_tree(k2, ch, num_classes)
    return tree


def _vit_tree(key, num_classes: int, in_ch: int, d: int = 96,
              layers: int = 4, patch: int = 4) -> dict:
    key, k1, k2, k3 = prng.split(key, 4)
    tree = {"patch": _fc_tree(k1, patch * patch * in_ch, d),
            "pos": normal_init(k2, (1 + (16 // patch) ** 2, d), 0.02),
            "cls": normal_init(k3, (d,), 0.02), "blocks": []}
    for _ in range(layers):
        key, k1, k2, k3, k4 = prng.split(key, 5)
        tree["blocks"].append({
            "qkv": _fc_tree(k1, d, 3 * d), "proj": _fc_tree(k2, d, d),
            "up": _fc_tree(k3, d, 4 * d), "down": _fc_tree(k4, 4 * d, d),
            "n1": _gn_tree(d), "n2": _gn_tree(d)})
    _, k1 = prng.split(key)
    tree["fc"] = _fc_tree(k1, d, num_classes)
    return tree


def _classifier_tree(key, name: str, num_classes: int,
                         in_ch: int = 3) -> dict:
    """The reference's ``init_classifier(key, name, ...)`` tree (HWIO
    convolutions, (in, out) dense weights), drawn from the same keys on
    the CPU."""
    key = np.asarray(key, np.uint32)
    if name in _RESNETS:
        return _resnet_tree(key, name, num_classes, in_ch)
    if name == "vgg16":
        return _vgg_tree(key, num_classes, in_ch)
    if name == "densenet121":
        return _densenet_tree(key, num_classes, in_ch)
    if name == "vit_b16":
        return _vit_tree(key, num_classes, in_ch)
    raise ValueError(name)


def init_classifier(key, name: str, num_classes: int, in_ch: int = 3, *,
                    device=None) -> nn.Module:
    """The classifier the reference's ``init_classifier(key, ...)``
    initialises, drawn on the CPU and moved to ``device`` (the card unless
    the caller passes ``"cpu"``): the bits depend on the key alone."""
    device = resolve_device(device)
    tree = _classifier_tree(key, name, num_classes, in_ch)
    model = classifier_module(name, num_classes, in_ch, device="meta")
    model.load_state_dict(classifier_state_from_jax(tree, name), assign=True)
    return model.to(device)


def classifier_apply(model: nn.Module, x) -> torch.Tensor:
    """Logits (B, num_classes) of NHWC images ``x`` (B, H, W, C)."""
    return model(x)


def classifier_param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def classifier_logprob(model: nn.Module):
    """``fn(x, labels) -> (B,)`` log p(labels | x): the closure a
    classifier-guided request carries.  Freezes the model's parameters, so
    a guidance gradient forms no weight gradients."""
    model.requires_grad_(False).eval()

    def logprob(x, labels):
        logp = F.log_softmax(model(x), dim=-1)
        return logp.gather(1, labels.long()[:, None])[:, 0]
    return logprob
