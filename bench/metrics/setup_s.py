"""setup_s: seconds from the start of the process to the start of the
window (imports, the card, weights, kernels built or loaded, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
