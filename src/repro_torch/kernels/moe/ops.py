"""Public wrappers of the MoE's compact expert pass: the CUDA kernels of
``csrc/moe.cu`` for CUDA tensors, the plain versions (``ref.py``) for CPU
tensors.  ``models/moe.py::compact_pass`` calls them; each counts its
launches in ``.launches``.  On the card the experts are gated silu (every
MoE configuration of the repo) and widths are whole 16-byte chunks; any
other call raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_cuda_inputs, count_launch
from repro_torch.kernels.moe import kernel as K
from repro_torch.kernels.moe import ref
from repro_torch.kernels.moe.kernel import BM


def _check_layout(name: str, rows, tile_start, tiles_max: int, a) -> None:
    if tile_start.dtype != torch.int32 or tile_start.dim() != 1 \
            or tile_start.numel() < 2 or not tile_start.is_contiguous():
        raise ValueError(f"{name}: tile_start must be a contiguous (G + 1,) "
                         "int32 vector")
    if rows is not None and (rows.dtype != torch.int32
                             or rows.shape != (tiles_max * BM,)
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous "
                         f"({tiles_max * BM},) int32 vector")
    if tiles_max < 1:
        raise ValueError(f"{name}: tiles_max {tiles_max} < 1")
    for t in (rows, tile_start):
        if t is not None and t.device != a.device:
            raise ValueError(f"{name}: index vectors on another device")


def _check_weights(name: str, a, *ws) -> None:
    check_cuda_inputs(name, a, *ws)
    if a.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name} on CUDA: {a.dtype}; bf16 only")
    if a.dim() != 2 or a.stride(1) != 1 or a.stride(0) % 8 \
            or a.data_ptr() % 16:
        raise ValueError(f"{name}: rows must have unit stride, a row stride "
                         "of whole 16-byte chunks and a 16-byte aligned base")
    for w in ws:
        if w.shape != ws[0].shape or w.dim() != 3 or not w.is_contiguous() \
                or w.data_ptr() % 16:
            raise ValueError(f"{name}: weights must be contiguous (E, K, N) "
                             "of one shape, 16-byte aligned")
    E, Kd, N = ws[0].shape
    # rows of whole 16-byte chunks
    if a.shape[1] != Kd or min(Kd, N) < 8 or Kd % 8 or N % 8:
        raise ValueError(f"{name}: rows of {a.shape[1]} against weights "
                         f"{tuple(ws[0].shape)}")


def expert_up(x, rows, tile_start, up, gate, act: str, group_div: int,
              tiles_max: int):
    """(tiles_max·BM, fe): each compact row's up and gate products and
    activation (``ref.expert_up``).  x (rows of x, d); rows (tiles_max·BM,)
    int32; tile_start (G + 1,) int32; up, gate (E, d, fe); on the card
    ``act`` "silu" and a gate."""
    if x.device.type == "cpu":
        return ref.expert_up(x, rows, tile_start, up, gate, act, group_div,
                             tiles_max)
    if gate is None or act != "silu":
        raise NotImplementedError(
            f"moe expert_up on CUDA: act {act!r}, gate "
            f"{'none' if gate is None else 'given'}; gated silu only")
    _check_weights("moe expert_up", x, up, gate)
    _check_layout("moe expert_up", rows, tile_start, tiles_max, x)
    if (tile_start.numel() - 1) > up.shape[0] * group_div:
        raise ValueError(f"moe expert_up: {tile_start.numel() - 1} groups "
                         f"over {up.shape[0]} experts")
    out = K.grouped_gemm(x, rows, up, gate, tile_start, group_div,
                         tiles_max, "gated")
    count_launch(expert_up, "launches")
    return out


expert_up.launches = 0


def expert_down(h, tile_start, down, group_div: int, tiles_max: int):
    """(tiles_max·BM, d): each compact row of h times its expert's down
    weights (E, fe, d) (``ref.expert_down``)."""
    if h.device.type == "cpu":
        return ref.expert_down(h, tile_start, down, group_div, tiles_max)
    _check_weights("moe expert_down", h, down)
    _check_layout("moe expert_down", None, tile_start, tiles_max, h)
    if h.shape[0] != tiles_max * BM \
            or (tile_start.numel() - 1) > down.shape[0] * group_div:
        raise ValueError(f"moe expert_down: {h.shape[0]} rows for "
                         f"{tiles_max} tiles, {tile_start.numel() - 1} "
                         f"groups over {down.shape[0]} experts")
    out = K.grouped_gemm(h, None, down, None, tile_start, group_div,
                         tiles_max, "plain")
    count_launch(expert_down, "launches")
    return out


expert_down.launches = 0


def combine(y, pair_rows, pair_gates):
    """(tokens, d): each token's weighted rows of y summed in ascending
    expert order (``ref.combine``).  y (rows, d); pair_rows (tokens, k)
    int32; pair_gates (tokens, k) fp32."""
    if y.device.type == "cpu":
        return ref.combine(y, pair_rows, pair_gates)
    check_cuda_inputs("moe combine", y)
    check_cuda_inputs("moe combine", pair_rows)
    check_cuda_inputs("moe combine", pair_gates)
    if y.dtype != torch.bfloat16 or pair_rows.dtype != torch.int32 \
            or pair_gates.dtype != torch.float32:
        raise NotImplementedError(
            f"moe combine on CUDA: {y.dtype}, {pair_rows.dtype}, "
            f"{pair_gates.dtype}; bf16 rows, int32 rows, fp32 gates only")
    if len({y.device, pair_rows.device, pair_gates.device}) != 1:
        raise ValueError("moe combine: tensors on different devices")
    if y.dim() != 2 or not y.is_contiguous() or y.shape[1] % 8 \
            or pair_rows.dim() != 2 or pair_rows.shape != pair_gates.shape \
            or not 1 <= pair_rows.shape[1] <= K.MAX_TOP_K \
            or not pair_rows.is_contiguous() \
            or not pair_gates.is_contiguous():
        raise ValueError(f"moe combine: y {tuple(y.shape)}, rows "
                         f"{tuple(pair_rows.shape)}, gates "
                         f"{tuple(pair_gates.shape)}")
    out = K.combine(y, pair_rows, pair_gates)
    count_launch(combine, "launches")
    return out


combine.launches = 0
