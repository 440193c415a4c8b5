"""Operations and bytes of one attention call, from its shapes: the real
head dim (not a kernel's class), q, k and v read once and o written once,
two products (q·kᵀ and p·v) over the (query, key) pairs the mask leaves."""
from __future__ import annotations


def pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a (batch, head) attends; a causal query i sees the
    keys up to i + (Sk − Sq)."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, max(0, i + 1 + Sk - Sq)) for i in range(Sq))


def flops(B: int, Sq: int, Sk: int, Hq: int, hd: int, causal: bool) -> int:
    return 4 * B * Hq * hd * pairs(Sq, Sk, causal)


def bytes_moved(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                itemsize: int) -> int:
    return itemsize * (2 * B * Sq * Hq * hd + 2 * B * Sk * Hkv * hd)


def least_seconds(call: dict, peaks: dict) -> float:
    """The larger of the call's operations at the dtype's peak and its bytes
    at the HBM rate.  ``call``: B, Sq, Sk, Hq, Hkv, hd, causal, dtype
    (a ``peaks["flops_per_s"]`` key) and itemsize."""
    f = flops(call["B"], call["Sq"], call["Sk"], call["Hq"], call["hd"],
              call["causal"])
    b = bytes_moved(call["B"], call["Sq"], call["Sk"], call["Hq"],
                    call["Hkv"], call["hd"], call["itemsize"])
    return max(f / peaks["flops_per_s"][call["dtype"]],
               b / peaks["hbm_bytes_per_s"])


#: the region a traced run wraps around the program's attention entry
REGION = ("attention", "repro_torch.kernels.flash_attention.ops",
          "flash_attention")


def call_shape(args: list, kwargs: dict) -> dict:
    """A recorded ``flash_attention(q, k, v, causal=...)`` call (its
    arguments as ``tracing.observe`` records them) as ``least_seconds``
    takes it: q (B, Sq, Hq, hd), k (B, Sk, Hkv, hd)."""
    q, k = args[0], args[1]
    B, Sq, Hq, hd = q["shape"]
    return {"B": B, "Sq": Sq, "Sk": k["shape"][1], "Hq": Hq,
            "Hkv": k["shape"][2], "hd": hd,
            "causal": bool(kwargs.get("causal", True)),
            "dtype": q["dtype"], "itemsize": q["itemsize"]}


def roofline_share(ctx) -> float | None:
    """The least time of the attention calls made inside the window over
    the device time inside the ``attention`` region, in percent; None when
    the trace has no such region or no call was made."""
    tr = ctx["trace"]
    name = REGION[0]
    w = ctx["window"]
    calls = [c for c in ctx["calls"].get(name, ())
             if w.start <= c[0] < w.stop]
    if not tr or not calls or not tr["region_s"].get(name):
        return None
    least = sum(least_seconds(call_shape(a, kw), ctx["peaks"])
                for _, a, kw in calls)
    return 100.0 * least / tr["region_s"][name]
