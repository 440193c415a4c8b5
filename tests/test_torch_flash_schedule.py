"""The tensor-core flash kernel's host side, on the CPU: which calls take
the tensor-core route (``kernel.tensor_core_route``) and the work list
that schedules its blocks (``kernel.work_list``), held against the masks
of ``models/attention.make_mask``.  No card and no launch."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models.attention import make_mask
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BQ, BK = K.TC_BLOCK_Q, K.TC_BLOCK_K


def _qkv(hd=256, dtype=torch.bfloat16, Hkv=4):
    return (torch.zeros(2, 70, 8, hd, dtype=dtype),
            torch.zeros(2, 70, Hkv, hd, dtype=dtype),
            torch.zeros(2, 70, Hkv, hd, dtype=dtype))


@pytest.mark.parametrize("hd", [16, 48, 64, 128, 192, 256])
def test_bf16_head_dims_that_are_multiples_of_16_take_the_tensor_cores(hd):
    assert K.tensor_core_route(*_qkv(hd))


@pytest.mark.parametrize("hd", [8, 36, 100, 264])
def test_other_head_dims_take_the_cuda_cores(hd):
    assert not K.tensor_core_route(*_qkv(hd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_other_dtypes_take_the_cuda_cores(dtype):
    assert not K.tensor_core_route(*_qkv(256, dtype))


@pytest.mark.parametrize("hd,hdv,takes", [
    (192, 128, True), (144, 80, False), (192, 112, False), (256, 128, False),
    (128, 64, False), (192, 64, False), (192, 136, False), (192, 120, False)])
def test_v_of_its_own_head_dim_takes_the_tensor_cores_in_the_192_128_class(
        hd, hdv, takes):
    """q·k at 192 against v at 128 alone (the (192, 128) class); latent
    attention's v as it comes out of the up projection, a view 256 elements
    a head apart, 128 elements in."""
    q, k, _ = _qkv(hd)
    v = torch.zeros(2, 70, 4, hdv, dtype=torch.bfloat16)
    assert K.split_head_dims(hd, hdv) == takes
    assert K.tensor_core_route(q, k, v) == takes
    kv = torch.zeros(2, 70, 16, 256, dtype=torch.bfloat16)
    assert K.tensor_core_route(torch.zeros(2, 70, 16, 192,
                                           dtype=torch.bfloat16),
                               torch.zeros(2, 70, 16, 192,
                                           dtype=torch.bfloat16),
                               kv[..., 128:])


def test_views_whose_strides_tma_can_address_take_the_tensor_cores():
    # the DiT's (B, S, 3, H, hd) QKV buffer, a (B, H, S, hd) transpose and
    # gemma2's reshaped projections
    qkv = torch.zeros(2, 17, 3, 4, 64, dtype=torch.bfloat16)
    assert K.tensor_core_route(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    bhsd = torch.zeros(2, 8, 70, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert K.tensor_core_route(bhsd, bhsd, bhsd)
    x = torch.zeros(2, 70, 8 * 256, dtype=torch.bfloat16)
    assert K.tensor_core_route(x.reshape(2, 70, 8, 256),
                               x[..., :1024].reshape(2, 70, 4, 256),
                               x[..., 1024:].reshape(2, 70, 4, 256))


def test_strides_or_pointers_tma_cannot_address_take_the_cuda_cores():
    q, k, v = _qkv(64)
    padded = torch.zeros(2, 70, 8, 68, dtype=torch.bfloat16)
    assert not K.tensor_core_route(padded[..., :64], k, v)   # 136-byte heads
    assert not K.tensor_core_route(padded[..., 4:], k, v)    # 8-byte offset
    assert not K.tensor_core_route(q, k[:, :, :1].expand(2, 70, 4, 64), v)
    assert not K.tensor_core_route(q[..., ::2], k[..., ::2], v[..., ::2])
    assert K.tensor_core_route(q[:, 3:], k[:, 5:], v[:, 1:])  # whole rows off


SCHEDULES = ([(S, S, True, w) for S in (1, 63, 64, 65, 100, 129, 4608)
              for w in (0, 64, 65, 4096)]
             + [(S, S, False, w) for S in (1, 65, 129, 4608) for w in (0, 65)]
             + [(Sq, Sk, False, w) for Sq, Sk in ((100, 37), (37, 300),
                                                  (1, 129), (65, 4608))
                for w in (0, 64)])


@pytest.mark.parametrize("Sq,Sk,causal,window", SCHEDULES)
def test_work_list_covers_the_mask_and_visits_no_masked_tile(Sq, Sk, causal,
                                                             window):
    work = K.work_list(Sq, Sk, causal, window)
    n_q = -(-Sq // BQ)
    assert work.dtype == np.int32 and work.shape == (n_q, 3)
    # every query tile exactly once, heaviest first
    assert sorted(work[:, 0].tolist()) == list(range(n_q))
    length = work[:, 2] - work[:, 1]
    assert (length >= 0).all() and (np.diff(length) <= 0).all()
    mask = make_mask(Sq, Sk, causal=causal, window=window).numpy()
    pad = np.zeros((n_q * BQ, -(-Sk // BK) * BK), bool)
    pad[:Sq, :Sk] = mask
    seen = pad.reshape(n_q, BQ, -1, BK).any(axis=(1, 3))  # (q tile, k tile)
    visited = np.zeros_like(seen)
    for tile, lo, hi in work:
        visited[tile, lo:hi] = True
    # every pair the mask leaves falls in a visited tile, and no visited
    # tile is masked for all of its rows
    assert not (seen & ~visited).any()
    assert not (visited & ~seen).any()


def test_work_list_of_gemma2_prefill_starts_with_the_longest_tiles():
    work = K.work_list(4608, 4608, True, 0)
    assert work[0].tolist() == [35, 0, 72] and work[-1].tolist() == [0, 0, 2]
    local = K.work_list(4608, 4608, True, 4096)
    assert (local[:, 2] - local[:, 1]).max() == 66     # 4096 / 64 + 2
