"""A frozen copy of the threefry-2x32 draws that the D_syn sampler uses:
``fold_in``, ``split`` and ``normal`` as ``jax.random`` defines them
(``jax_threefry_partitionable``), so the reference can work out x_T and
every step's noise again from the wave's key.

Kept apart from the program on purpose: the check must not take its noise
from the code it judges.  Keys are (..., 2) uint32 numpy arrays, derived on
the host; bits and normals are computed with torch on the given device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# nextafter(-1, 0) in float32, the uniform's lower end under erfinv
UNIFORM_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
SQRT2 = float(np.float32(np.sqrt(2)))
# Giles' single-precision erfinv, as XLA evaluates it (split at w = 5)
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def hash2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, of the counts (x1, x2) under the key
    (k1, k2); int64 arrays or tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _halves(keys):
    k = np.asarray(keys, np.uint32).astype(np.int64)
    return k[..., 0].copy(), k[..., 1].copy()


def fold_in(keys, data) -> np.ndarray:
    """The hash of the counts (0, data) under each key."""
    k1, k2 = _halves(keys)
    d = np.asarray(data, np.int64) & MASK
    return np.stack(hash2x32(k1, k2, np.zeros_like(d), d),
                    axis=-1).astype(np.uint32)


def split(keys, num: int = 2) -> np.ndarray:
    """(..., num, 2): key i is the hash of the counts (0, i)."""
    k1, k2 = _halves(keys)
    i = np.arange(num, dtype=np.int64)
    return np.stack(hash2x32(k1[..., None], k2[..., None], np.zeros_like(i),
                             i), axis=-1).astype(np.uint32)


def bits(key, size: int, offset: int, device) -> torch.Tensor:
    """Elements ``offset .. offset + size`` of one key's uint32 draw (int64
    tensor): element n hashes the counts (0, n) and xors the two words."""
    if offset + size >= 2 ** 32:
        raise ValueError("more than 2**32 draws from one key")
    k1, k2 = (torch.tensor(int(w), dtype=torch.int64, device=device)
              for w in np.asarray(key, np.uint32))
    n = torch.arange(offset, offset + size, dtype=torch.int64, device=device)
    b1, b2 = hash2x32(k1, k2, torch.zeros_like(n), n)
    return b1 ^ b2


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, ERFINV_LT5[0], ERFINV_GE5[0])
    for c_lt, c_ge in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, device, offset: int = 0) -> torch.Tensor:
    """Standard normals (float32) of one key: the elements ``offset ..``
    of its draw, shaped ``shape``.  The top 23 bits make a float in [1, 2);
    less 1, it is mapped onto [nextafter(-1, 0), 1) in one rounding, and
    √2·erfinv of that is the normal."""
    size = math.prod(shape)
    b = bits(key, size, offset, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(UNIFORM_LO))
    u = torch.clamp((f.double() * span + UNIFORM_LO).float(), min=UNIFORM_LO)
    return (SQRT2 * _erfinv(u)).reshape(shape)
