"""Operations and bytes of one latent-attention call (the flash wrapper's
call with q·k at one head dim and v at another), from its shapes and the
configuration: q·kᵀ at the call's q head dim, p·v at the configuration's
``v_head_dim`` (so that a route that pads v is not credited for the
padding), over the (query, key) pairs the mask leaves; q, k and v read
once at their own widths and o written once at v's."""
from __future__ import annotations

import functools

from bench.yardstick import attention

REGION = attention.REGION
_pairs = functools.lru_cache(maxsize=64)(attention.pairs)


def flops(B: int, Sq: int, Sk: int, Hq: int, dqk: int, dv: int,
          causal: bool) -> int:
    return 2 * B * Hq * (dqk + dv) * _pairs(Sq, Sk, causal)


def bytes_moved(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, dqk: int,
                dv: int, itemsize: int) -> int:
    return itemsize * (B * Sq * Hq * (dqk + dv) + B * Sk * Hkv * (dqk + dv))


def least_seconds(call: dict, dv: int, peaks: dict) -> float:
    """The larger of the call's operations at the dtype's peak and its bytes
    at the HBM rate; ``call`` as ``attention.call_shape`` gives it."""
    f = flops(call["B"], call["Sq"], call["Sk"], call["Hq"], call["hd"], dv,
              call["causal"])
    b = bytes_moved(call["B"], call["Sq"], call["Sk"], call["Hq"],
                    call["Hkv"], call["hd"], dv, call["itemsize"])
    return max(f / peaks["flops_per_s"][call["dtype"]],
               b / peaks["hbm_bytes_per_s"])


def roofline_share(ctx) -> float | None:
    """The least time of the window's attention calls over the device time
    inside the ``attention`` region, in percent; None when the trace has
    no such region or no call was made."""
    tr = ctx["trace"]
    name = REGION[0]
    w = ctx["window"]
    calls = [c for c in ctx["calls"].get(name, ())
             if w.start <= c[0] < w.stop]
    if not tr or not calls or not tr["region_s"].get(name):
        return None
    dv = ctx["config"]["v_head_dim"]
    least = sum(least_seconds(attention.call_shape(a, kw), dv, ctx["peaks"])
                for _, a, kw in calls)
    return 100.0 * least / tr["region_s"][name]
