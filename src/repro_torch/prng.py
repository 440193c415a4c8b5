"""Threefry-2x32 keys, random bits and normals, bit-compatible with
``jax.random`` under ``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True``.

A key is a uint32 pair; a batch of keys is a (..., 2) uint32 numpy array.
Keys are derived on the host in numpy: one hash per key, cheap, and no
launch on the card.  Random bits and normals for the big tensors are
computed with torch on the tensor's device, one vectorised call for a
whole batch of keys.

Both paths do the uint32 arithmetic in int64 with ``& 0xFFFFFFFF`` after
every add and shift (torch has no CPU shift on uint32).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# nextafter(-1, 0) in float32: jax's lower bound for the uniform under erfinv
_UNIFORM_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 erf: an odd rational function of x (Eigen's), saturating
# to ±1 past the last float32 whose erf rounds below 1
_ERF_P = (0.00022905065861350646, 0.0034082910107109506,
          0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185,
          0.0010179625278914885, 0.014070470171167667,
          0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_SATURATE = 3.832506856900711


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pair (x1, x2) under
    the key pair (k1, k2); every operand an int64 array or tensor holding
    uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _halves(keys):
    keys = np.asarray(keys)
    if keys.shape[-1:] != (2,) or keys.dtype != np.uint32:
        raise TypeError(f"keys must be a (..., 2) uint32 array, got "
                        f"{keys.dtype} {keys.shape}")
    k = keys.astype(np.int64)
    # contiguous halves: torch lays out a result like its operands
    return k[..., 0].copy(), k[..., 1].copy()


def _pack(x1, x2) -> np.ndarray:
    return np.stack([x1, x2], axis=-1).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as jax builds it with 64-bit mode off
    (its default): the seed wraps to 32 bits, which become the low word."""
    return np.array([0, int(seed) & MASK], np.uint32)


def fold_in(keys, data) -> np.ndarray:
    """``jax.random.fold_in`` over a batch: the hash of the count pair
    (0, data) under each key.  ``data`` (integers, taken mod 2**32)
    broadcasts against the batch shape ``keys.shape[:-1]``."""
    k1, k2 = _halves(keys)
    d = np.asarray(data, np.int64) & MASK
    return _pack(*_threefry2x32(k1, k2, np.zeros_like(d), d))


def split(keys, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (..., num, 2); key i is ``fold_in(key, i)``
    (jax's partitionable "foldlike" split)."""
    k1, k2 = _halves(keys)
    i = np.arange(num, dtype=np.int64)
    return _pack(*_threefry2x32(k1[..., None], k2[..., None],
                                np.zeros_like(i), i))


def random_bits(keys, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for every key of the batch
    ``keys`` (..., 2): an int64 tensor (..., *shape) on ``device`` holding
    the uint32 values.  Element n of a key's draw hashes the count pair
    (n >> 32, n & 0xFFFFFFFF) and xors the two output words.

    ``offset`` shifts the counts: elements ``offset .. offset + size`` of a
    larger draw, so a big draw made in pieces has the bits of one call."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if offset + size >= 2 ** 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    k1, k2 = _halves(keys)
    batch = k1.shape
    k1, k2 = (torch.as_tensor(k, device=device).reshape(*batch, 1)
              for k in (k1, k2))
    lo = torch.arange(offset, offset + size, dtype=torch.int64,
                      device=device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(tuple(batch) + shape)


def uniform_bits_to_float(bits: torch.Tensor, lo: float, hi: float):
    """jax's ``_uniform`` map of uint32 bits to float32 in [lo, hi): the top
    23 bits become the mantissa of a float in [1, 2), less 1, then scaled
    and shifted.

    XLA contracts jax's ``floats · (hi − lo) + lo`` into one fused
    multiply-add, so the map runs in float64 (a float32 product is exact
    there) and rounds once to float32: bit for bit as jax on [0, 1), on
    ``normal``'s span (a product by 2, exact either way) and on the
    initialisers' truncation span."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = float(np.float32(lo))
    span = float(np.float32(hi) - np.float32(lo))     # rounded as in float32
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erfinv (Giles' degree-9 polynomials in
    w = −log1p(−x²), split at w = 5), as jax lowers ``lax.erf_inv``.
    ``torch.erfinv`` is more accurate but differs from XLA's by up to ~90
    ulps; this matches it to 3 ulps (XLA's ``log1p`` and its fused
    multiply-adds account for the rest)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def erf_f32(x) -> np.ndarray:
    """XLA's float32 ``erf`` of the float32 array ``x``, on the host: the
    polynomials evaluated with fused multiply-adds (each emulated in
    float64, where a float32 product is exact, then rounded once).  Equal
    to ``jax.lax.erf`` at the truncation bounds the initialisers use and
    within a few ulps elsewhere."""
    x = np.asarray(x, np.float32)
    x2 = x * x

    def poly(coeffs):
        acc = np.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            acc = (x2.astype(np.float64) * acc + np.float32(c)).astype(
                np.float32)
        return acc

    r = (x * poly(_ERF_P)) / poly(_ERF_Q)
    return np.where(np.abs(x) <= np.float32(_ERF_SATURATE), r,
                    np.copysign(np.float32(1), x)).astype(np.float32)


def uniform(keys, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for every
    key of the batch ``keys`` (..., 2): a float32 tensor (..., *shape) on
    ``device`` (see ``uniform_bits_to_float``; ``offset`` as in
    ``random_bits``)."""
    return uniform_bits_to_float(random_bits(keys, shape, device, offset),
                                 minval, maxval)


def bernoulli(keys, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a float32 ``p``: a bool
    tensor (..., *shape), ``uniform(key, shape) < p``, bit for bit."""
    return uniform(keys, shape, device=device) < float(np.float32(p))


def truncated_normal(keys, lower: float, upper: float, shape,
                     device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32
    for every key of the batch ``keys`` (..., 2), as jax 0.9 builds it: u
    uniform on [erf(lower/√2), erf(upper/√2)) (XLA's float32 ``erf``), then
    √2·erfinv(u), clipped into the open interval (lower, upper).  Within a
    few ulps of jax (``erfinv`` is within 3)."""
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = erf_f32(np.array([lo, hi]) / np.float32(_SQRT2))
    u = uniform(keys, shape, float(a), float(b), device, offset)
    out = _SQRT2 * erfinv(u)
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))


def normal(keys, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 for every key of the
    batch ``keys`` (..., 2): a tensor (..., *shape) on ``device``.

    √2·erfinv(u) with u uniform on [nextafter(-1, 0), 1), built from the
    bits exactly as jax builds it; within 3 ulps of jax (see ``erfinv``)."""
    u = uniform_bits_to_float(random_bits(keys, shape, device, offset),
                              _UNIFORM_LO, 1.0)
    return _SQRT2 * erfinv(u)


def randint(keys, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for every
    key of the batch ``keys`` (..., 2): an int32 tensor (..., *shape) on
    ``device``, bit for bit as jax 0.9 draws it.

    jax splits each key in two, draws 32 bits from each half and maps the
    pair onto the span in uint32 arithmetic: ``(hi % span) · multiplier +
    lo % span``, wrapped to 32 bits, then ``% span``, where ``multiplier =
    (2**16 % span)**2 % span`` (the square wraps too, so it is 0 for a span
    above 2**16).  A span of 0 or less gives ``minval``."""
    i32_min, i32_max = -2 ** 31, 2 ** 31 - 1
    out_of_range = maxval > i32_max
    lo_v = min(max(int(minval), i32_min), i32_max)
    hi_v = min(max(int(maxval), i32_min), i32_max)
    span = (hi_v - lo_v) & MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    mult = ((2 ** 16 % span) ** 2 & MASK) % span if span else 0
    halves = split(keys)
    higher = random_bits(halves[..., 0, :], shape, device)
    lower = random_bits(halves[..., 1, :], shape, device)
    if span:
        offset = (((higher % span) * mult) + lower % span) & MASK
        offset = offset % span
    else:                       # XLA's unsigned remainder by 0 is the dividend
        offset = (higher * mult + lower) & MASK
    val = (lo_v + offset) & MASK
    return torch.where(val > i32_max, val - 2 ** 32, val).to(torch.int32)

