"""The host side of the CUDA-core flash kernel and of the rmsnorm kernel, on
the CPU: their launch geometries (``cuda_core_geometry``,
``cuda_core_blocks``; ``rmsnorm/kernel.geometry``, ``rows_of_block``),
replayed block by block as the kernels index and held against
``models/attention.make_mask``, and which rmsnorm views are read 16 bytes
at a time (``vector_route``).  No card and no launch."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.models.attention import make_mask
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LENGTHS = (1, 33, 63, 64, 65, 129, 3137, 4608)
# (causal, window, query heads, kv heads)
MODES = {"noncausal": (False, 0, 2, 2), "causal": (True, 0, 2, 2),
         "window": (True, 40, 2, 2), "gqa_window": (True, 40, 4, 2),
         "mqa": (True, 0, 4, 1), "noncausal_window": (False, 40, 2, 2)}


@pytest.mark.parametrize("hd", [1, 16, 17, 32, 36, 48, 64, 80, 96, 128,
                                200, 256])
def test_cuda_core_instances_fit_an_h100_block(hd):
    hdp, bm, bn, G, P, n_pt, blocks, smem = K.cuda_core_geometry(
        2, 8, 4, 100, hd)
    assert hdp in K.CUDA_CORE_TILES and hd <= hdp
    assert all(c >= hdp for c in K.CUDA_CORE_TILES if c >= hd)
    assert (bm, bn) == K.CUDA_CORE_TILES[hdp]
    # 32 row groups x 8 key groups, each with whole rows and keys
    assert bm % 32 == 0 and bn % 8 == 0 and hdp % 8 == 0
    assert smem == K.cuda_core_smem(hdp) <= K.MAX_SMEM
    assert G * P == bm and G & (G - 1) == 0 and 16 * G <= bm
    assert n_pt == -(-100 // P) and blocks == n_pt * 2 * 4 * (2 // G)


def test_cuda_core_geometry_of_the_paths_that_take_it():
    # the DiT at 224 px: S = 3137, 4 heads of 32 (phase 2) or 36 (preset)
    assert K.cuda_core_geometry(4, 4, 4, 3137, 32) == (
        32, 128, 64, 1, 128, 25, 400, 4 * (128 * 36 + 4 * 64 * 36
                                           + 64 * 132 + 256))
    assert K.cuda_core_geometry(8, 4, 4, 3137, 36)[:2] == (48, 128)
    # gemma2 in fp32: 8 query heads over 4 kv heads of 256, one block takes
    # both query heads of a kv head at 32 positions
    hdp, bm, bn, G, P, n_pt, blocks, smem = K.cuda_core_geometry(
        1, 8, 4, 4608, 256)
    assert (hdp, bm, bn, G, P, n_pt, blocks) == (256, 64, 32, 2, 32, 144,
                                                 576)
    assert smem == 4 * (64 * 260 + 4 * 32 * 260 + 32 * 68 + 128) <= 232448


def _replay(B, Hq, Hkv, S, hd, causal, window):
    """Visit every block as the kernel does; per (batch, query head) count
    how often each (query, key) pair the mask leaves is computed, and check
    that no visited key tile is masked for every row of its block."""
    _, bm, bn, G, P, _, blocks, _ = K.cuda_core_geometry(B, Hq, Hkv, S, hd)
    mask = make_mask(S, S, causal=causal, window=window).numpy()
    work = list(K.cuda_core_blocks(B, Hq, Hkv, S, S, hd, causal, window))
    assert len(work) == blocks
    tiles = []
    for b, h0, q0, first, end in work:
        assert h0 % G == 0 and (h0 + G - 1) // (Hq // Hkv) == h0 // (
            Hq // Hkv)                       # one kv head a block
        rows = slice(q0, min(q0 + P, S))
        for t in range(first, min(end, S), bn):
            assert mask[rows, t:t + bn].any(), "a fully masked tile"
        tiles.append((end - first) // bn)
    for b in range(B):
        for h in range(Hq):
            counts = np.zeros((S, S), np.uint8)
            for bb, h0, q0, first, end in work:
                if bb == b and h0 <= h < h0 + G:
                    rows, keys = slice(q0, min(q0 + P, S)), slice(first, end)
                    counts[rows, keys] += mask[rows, keys]
            assert (counts == mask).all()    # each visible pair once
    return tiles, P % bn == 0 and S % P == 0


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hd", [32, 256])
def test_cuda_core_blocks_visit_every_visible_pair_once(S, mode, hd):
    causal, window, Hq, Hkv = MODES[mode]
    B = 2 if S < 1000 else 1
    tiles, whole = _replay(B, Hq, Hkv, S, hd, causal, window)
    # heaviest first: a later block never sees more key tiles (one more at
    # most where a block's positions are not whole key tiles, or the last
    # position tile is cut short by the sequence's end)
    assert all(b <= a + (0 if whole else 1) for a, b in zip(tiles, tiles[1:]))


def test_cuda_core_blocks_of_8c_start_with_the_longest_tiles():
    work = list(K.cuda_core_blocks(1, 8, 4, 4608, 4608, 256, True, 4096))
    b, h0, q0, first, end = work[0]
    assert q0 == 4576 and (first, end) == (480, 4608)
    b, h0, q0, first, end = work[-1]
    assert q0 == 0 and (first, end) == (0, 32)


@pytest.mark.parametrize("d", [1, 96, 100, 2304, 8192])
@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("rows,grid", [(1, 1), (37, 5), (37, 132),
                                       (300, 7)])
def test_rmsnorm_geometry_covers_every_row_and_column_once(d, size, rows,
                                                           grid):
    nv, W = RK.geometry(d, size)
    chunks = -(-d // (16 // size))
    assert 1 <= nv <= RK.MAX_CHUNKS_PER_LANE and W in RK.WARPS_PER_ROW
    assert nv == -(-chunks // (32 * W))
    assert W == 1 or 32 * (W // 2) * RK.MAX_CHUNKS_PER_LANE < chunks
    seen = np.zeros(rows, int)
    for blk in range(grid):
        for row, warps in RK.rows_of_block(blk, grid, rows, W):
            seen[row] += 1
            assert len(warps) == W and max(warps) < RK.WARPS
    assert (seen == 1).all()
    # lane l of warp w of a row holds chunks (j * W + w) * 32 + l, j < nv
    held = [(j * W + w) * 32 + lane for j in range(nv) for w in range(W)
            for lane in range(32)]
    held = [c for c in held if c < chunks]
    assert sorted(held) == list(range(chunks))


def test_rmsnorm_geometry_of_gemma2():
    assert RK.geometry(2304, 2) == (9, 1)      # 288 chunks, 9 a lane
    assert RK.geometry(2304, 4) == (9, 2)
    assert RK.geometry(8192, 2) == (8, 4)
    assert RK.geometry(8192, 4) == (8, 8)


@pytest.mark.parametrize("dtype,d,vec", [
    (torch.bfloat16, 2304, True), (torch.float32, 2304, True),
    (torch.float32, 100, True), (torch.bfloat16, 100, False),
    (torch.float32, 97, False), (torch.bfloat16, 8, True)])
def test_rmsnorm_vector_route_needs_whole_16_byte_rows(dtype, d, vec):
    assert RK.vector_route(torch.zeros(6, d, dtype=dtype)) == vec


def test_rmsnorm_vector_route_refuses_padded_or_unaligned_views():
    x = torch.zeros(6, 2320, dtype=torch.bfloat16)
    assert RK.vector_route(x[:, :2304])          # rows 2320 apart: whole
    assert RK.vector_route(x[:, 8:2312])         # 16 bytes in
    assert not RK.vector_route(x[:, 1:2305])     # 2 bytes off
    assert not RK.vector_route(
        torch.zeros(6, 2310, dtype=torch.bfloat16)[:, :2304])  # padded rows


def test_cuda_core_threads_match_the_source():
    # the empty launch of the CUDA-core kernel's floor takes its block size
    # from CUDA_CORE_THREADS
    src = K.SOURCE.read_text()
    assert f"constexpr int kThreads = {K.CUDA_CORE_THREADS};" in src
