"""dsyn.mfu: the DiT's useful operations over the window's seconds, as a
share of the card's float32 peak outside the tensor cores (the
configuration computes in float32 with TF32 off).  Useful: the active
row-iterations of the window (engine counters), times 2 rows (conditional
and null), times the operations of one row of one denoiser call
(``yardstick/dit.py``)."""
from bench.yardstick import dit


def read(ctx):
    st = ctx["facts"].get("stats")
    if not st or "end" not in st:
        return None
    act = st["end"]["row_iters_active"] - st["begin"]["row_iters_active"]
    flops = act * 2 * dit.row_call_flops(ctx["config"])
    peak = ctx["peaks"]["flops_per_s"][ctx["config"]["dtype"]]
    return 100.0 * flops / ctx["seconds"] / peak
