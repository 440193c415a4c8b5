"""Device selection, deterministic cuDNN, parameter initialisers and the
logit soft cap.

The initialisers draw from an explicit ``torch.Generator``; their values
are the port's own and do not reproduce the JAX package's threefry draws.
Parameters that must equal the reference's come through
``repro_torch.convert`` instead.
"""
from __future__ import annotations

import contextlib
import math

import torch


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


def normal_init(shape, generator: torch.Generator | None = None,
                stddev: float = 0.02, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * stddev


def lecun_init(shape, generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan_in = shape[0])."""
    w = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w / math.sqrt(max(shape[0], 1))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap · tanh(x / cap)``: gemma2's logit soft cap."""
    return cap * torch.tanh(x / cap)
