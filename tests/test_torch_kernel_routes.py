"""The host side of the DiT's two CUDA kernels, on the CPU: which calls take
the short-sequence attention kernel (``short_seq_route``) and which inputs
each kernel reads 16 bytes at a time (``vector_loads``,
``vector_route``), as plain functions of shape, strides and pointers; and
their launch geometries (``short_geometry``, ``geometry``), replayed here
block by block and warp by warp as the kernels index.  No card and no
launch."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.adaln_norm import kernel as AN
from repro_torch.kernels.cfg_fuse import kernel as CK
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.rmsnorm import kernel as RK
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _qkv(Sq=17, Sk=17, hd=36, Hq=4, Hkv=4, dtype=torch.float32):
    return (torch.zeros(2, Sq, Hq, hd, dtype=dtype),
            torch.zeros(2, Sk, Hkv, hd, dtype=dtype),
            torch.zeros(2, Sk, Hkv, hd, dtype=dtype))


@pytest.mark.parametrize("Sq,Sk,hd,short", [
    (1, 1, 1, True), (17, 17, 36, True), (32, 32, 64, True),
    (33, 32, 64, False), (32, 33, 64, False), (32, 32, 65, False),
    (17, 100, 32, False), (100, 17, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_route_takes_s_up_to_32_and_head_dims_up_to_64(Sq, Sk, hd,
                                                             short, dtype):
    assert K.short_seq_route(*_qkv(Sq, Sk, hd, dtype=dtype)) == short


def test_short_route_takes_fp32_and_bf16_only_and_any_gqa():
    assert not K.short_seq_route(*_qkv(dtype=torch.float16))
    assert K.short_seq_route(*_qkv(Hq=8, Hkv=1))
    assert K.short_seq_route(*_qkv(Hq=6, Hkv=2))


def test_short_route_takes_views_it_reads_one_element_at_a_time():
    # the DiT's (B, S, 3, H, hd) QKV buffer: 16-byte reads
    qkv = torch.zeros(2, 17, 3, 4, 36)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert K.short_seq_route(q, k, v)
    assert all(K.vector_loads(t) for t in (q, k, v))
    # one element off 16-byte alignment, heads 37 elements apart, bf16 at
    # hd 36 (not whole 16-byte chunks): still the short kernel, one element
    # at a time
    pad = torch.zeros(2, 17, 4, 37)
    for view in (pad[..., 1:], pad[..., :36]):
        assert K.short_seq_route(view, view, view)
        assert not K.vector_loads(view)
    bf = _qkv(dtype=torch.bfloat16)
    assert K.short_seq_route(*bf) and not K.vector_loads(bf[0])
    assert K.vector_loads(_qkv(hd=32, dtype=torch.bfloat16)[0])
    # a (B, H, S, hd) layout seen as (B, S, H, hd)
    bhsd = torch.zeros(2, 4, 17, 36).transpose(1, 2)
    assert K.short_seq_route(bhsd, bhsd, bhsd) and K.vector_loads(bhsd)
    # no unit stride over hd: refused
    assert not K.short_seq_route(qkv[..., ::2], k[..., ::2], v[..., ::2])


GEOMETRIES = [(Hq, Hkv, S, hd) for Hq, Hkv in ((4, 4), (4, 2), (4, 1),
                                               (8, 4), (8, 1), (6, 2),
                                               (16, 16), (12, 4), (32, 1),
                                               (3, 3))
              for S, hd in ((17, 36), (32, 64), (1, 4))]


@pytest.mark.parametrize("Hq,Hkv,S,hd", GEOMETRIES)
def test_short_geometry_covers_every_head_once_within_48_kb(Hq, Hkv, S, hd):
    """The kernel's index math, block by block and warp by warp: every
    query head taken by one warp of one block, every kv head a query head
    reads staged by its block, and the shared memory within 48 KB."""
    hb, nkv_max, smem = K.short_geometry(Hq, Hkv, S, S, hd)
    rep, hdp = Hq // Hkv, -(-hd // 4) * 4
    assert 1 <= hb <= K.SHORT_MAX_WARPS and smem <= K.SHORT_MAX_SMEM
    assert smem == 4 * (hdp * (hb * S + 2 * nkv_max * S) + hb * S * 32)
    covered = np.zeros(Hq, int)
    for bx in range(-(-Hq // hb)):          # grid (ceil(Hq / hb), B)
        h0 = bx * hb
        nh = min(hb, Hq - h0)
        kv0 = h0 // rep
        nkv = (h0 + nh - 1) // rep - kv0 + 1
        assert nh >= 1 and nkv <= nkv_max
        for w in range(nh):                 # one warp per query head
            covered[h0 + w] += 1
            assert 0 <= (h0 + w) // rep - kv0 < nkv
    assert (covered == 1).all()


def test_short_geometry_of_the_dit():
    assert K.short_geometry(4, 4, 17, 17, 36) == (4, 4, 38080)
    assert K.short_geometry(4, 4, 17, 17, 32) == (4, 4, 4 * (32 * 204 + 2176))


@pytest.mark.parametrize("dtype,d,vec", [
    (torch.float32, 144, True), (torch.float32, 128, True),
    (torch.float32, 145, False), (torch.float32, 146, False),
    (torch.bfloat16, 144, True), (torch.bfloat16, 132, False)])
def test_adaln_vector_route_needs_whole_16_byte_rows(dtype, d, vec):
    x = torch.zeros(4, 18, d, dtype=dtype)
    assert AN.vector_route(x) == vec
    assert AN.vector_route(x[:, 1:]) == vec          # the tok[:, 1:] view


def test_adaln_vector_route_refuses_unaligned_rows():
    x = torch.zeros(4, 17, 148)
    assert AN.vector_route(x[..., 4:])               # 16 bytes in
    assert not AN.vector_route(x[..., 1:145])        # 4 bytes off
    assert not AN.vector_route(torch.zeros(4, 17, 150)[..., :144])


@pytest.mark.parametrize("B,N,d,vec,size", [
    (256, 17, 144, True, 4), (256, 16, 144, True, 4), (256, 17, 145, False, 4),
    (7, 1, 144, True, 4), (5, 3, 2048, True, 4), (3, 40, 2048, True, 4),
    (3, 100, 300, False, 4), (2, 33, 1024, True, 2), (9, 5, 40, True, 2),
    (1, 1, 1, False, 4)])
def test_adaln_geometry_covers_every_token_row_once(B, N, d, vec, size):
    nv, R, nb, blocks, smem = AN.geometry(B, N, d, vec, size)
    n = 16 // size
    need = -(-d // (32 * n)) * n if vec else -(-d // 32)
    assert nv in AN.VALUES_PER_LANE and need <= nv and d <= AN.MAX_D
    assert 1 <= R <= (32 if nv <= 16 else 16)
    assert smem == 8 * nb * d <= AN.MAX_SMEM
    covered = np.zeros(B * N, int)
    for blk in range(blocks):
        r0 = blk * R
        b0 = r0 // N
        for w in range(R):                  # one warp per token row
            r = r0 + w
            if r < B * N:
                covered[r] += 1
                assert 0 <= r // N - b0 < nb     # its batch row is staged
    assert (covered == 1).all()


def test_adaln_geometry_of_the_dit():
    # one block per batch row: 17 (16 for tok[:, 1:]) warps, 256 blocks
    assert AN.geometry(256, 17, 144, True, 4) == (8, 17, 1, 256, 1152)
    assert AN.geometry(256, 16, 144, True, 4) == (8, 16, 1, 256, 1152)


def test_launch_floors_share_one_empty_kernel():
    """Every launch floor is measured through ``build.empty_launch``: the
    kernels' own sources define no empty kernel, and the helper's source
    defines the one it launches."""
    for src in (AN.SOURCE, CK.SOURCE, K.SOURCE, K.SHORT_SOURCE, K.TC_SOURCE,
                RK.SOURCE):
        assert "empty_kernel" not in src.read_text(), src.name
    empty = build.EMPTY_SOURCE.read_text()
    assert "__global__ void empty_kernel() {}" in empty
    assert 'extern "C" int empty_launch(' in empty
