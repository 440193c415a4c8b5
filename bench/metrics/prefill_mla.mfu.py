"""prefill_mla.mfu: the operations the window's prefills of the DeepSeek-V3
block need (``yardstick/mla_lm.py``: twice the active parameters a token,
causal attention at q·k's and v's head dims, the LM head at each
request's last position) over the window's seconds, as a share of the
card's bf16 peak, in percent."""
from bench.yardstick import mla_lm


def read(ctx):
    f = ctx["facts"]
    if not f.get("lengths"):
        return None
    flops = sum(mla_lm.prefill_flops(ctx["config"], L) for L in f["lengths"])
    peak = ctx["peaks"]["flops_per_s"][ctx["config"]["dtype"]]
    return 100.0 * flops / ctx["seconds"] / peak
