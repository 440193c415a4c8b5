"""prefill.mfu: the operations the window's prefills need
(``yardstick/lm.py``: twice the active parameters a token, causal
attention, the LM head at each request's last position) over the window's
seconds, as a share of the card's bf16 peak, in percent."""
from bench.yardstick import lm


def read(ctx):
    f = ctx["facts"]
    if not f.get("lengths"):
        return None
    flops = sum(lm.prefill_flops(ctx["config"], L) for L in f["lengths"])
    peak = ctx["peaks"]["flops_per_s"][ctx["config"]["dtype"]]
    return 100.0 * flops / ctx["seconds"] / peak
