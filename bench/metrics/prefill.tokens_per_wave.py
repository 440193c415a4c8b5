"""prefill.tokens_per_wave: prompt tokens of the window over the engine's
``waves`` counter across it: how many tokens one prefill call takes."""


def read(ctx):
    f = ctx["facts"]
    if not f.get("waves"):
        return None
    return f["tokens"] / f["waves"]
