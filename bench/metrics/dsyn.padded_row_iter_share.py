"""dsyn.padded_row_iter_share: the share of the denoiser's row-iterations
in the window that no request needed (padding and frozen ragged rows):
1 − row_iters_active / row_iters_scheduled, from the engine's counters at
the window's two ends, in percent."""


def read(ctx):
    st = ctx["facts"].get("stats")
    if not st or "end" not in st:
        return None
    act = st["end"]["row_iters_active"] - st["begin"]["row_iters_active"]
    sch = st["end"]["row_iters_scheduled"] - \
        st["begin"]["row_iters_scheduled"]
    return None if sch <= 0 else 100.0 * (1.0 - act / sch)
