"""Device selection, deterministic cuDNN, parameter initialisers and the
logit soft cap.

``lecun_init`` and ``normal_init`` take a threefry key and draw what the
JAX package's initialisers of the same names draw from it (within a few
ulps: ``prng.truncated_normal`` and ``prng.normal``), on the CPU, so an
init's bits depend on the key alone on any device.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch import prng


def default_device() -> torch.device:
    """The CUDA card the port runs on.  Raises when there is none: the port
    never falls back to the CPU by itself (callers pass ``device="cpu"``).

    Also turns TF32 off for matmuls and convolutions: the parity gates
    against the reference are fp32 gates."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms inside the block:
    the card's default choice for a convolution's backward may add in no
    fixed order, so one input would give different gradient bits."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = prev


@contextlib.contextmanager
def recorded_relu(record):
    """``record(v)`` with the detached input ``v`` of every ``F.relu``
    call inside the block.  ReLU is the classifiers' only kink: an input
    that lies on one side of 0 in one run and on the other in a run that
    rounds otherwise moves a gradient by a step, not by rounding, so the
    checks that compare two devices' gradients read these inputs."""
    fn = torch.nn.functional
    relu = fn.relu

    def recorded(v, *args, **kwargs):
        record(v.detach())
        return relu(v, *args, **kwargs)

    fn.relu = recorded
    try:
        yield
    finally:
        fn.relu = relu


def normal_init(key, shape, stddev: float = 0.02) -> torch.Tensor:
    """``normal(key, shape) · stddev`` in float32 on the CPU, as the
    reference's ``normal_init`` (``stddev`` rounded to float32 first)."""
    return prng.normal(key, shape) * float(np.float32(stddev))


def lecun_init(key, shape, fan_in_axes=(0,)) -> torch.Tensor:
    """Truncated normal on [-2, 2] *times* 1/sqrt(fan_in), in float32 on
    the CPU, as the reference's ``lecun_init`` (the reference's
    convolutions divide instead, which rounds otherwise)."""
    fan_in = math.prod(shape[a] for a in fan_in_axes)
    std = float(np.float32(1.0 / math.sqrt(max(fan_in, 1))))
    return prng.truncated_normal(key, -2.0, 2.0, shape) * std


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap · tanh(x / cap)``: gemma2's logit soft cap."""
    return cap * torch.tanh(x / cap)
