"""prefill_tokens_per_s: prompt tokens of the batches finished inside the
window, over the time from the window's start to the end of the last of
them (whole batches only)."""


def read(ctx):
    f = ctx["facts"]
    if "lengths" not in f:
        return None
    return f["tokens"] / ctx["seconds"]
