"""prefill.device_idle_share: the share of the traced window in which no
kernel, copy or memset ran on the card, in percent."""
from bench import tracing


def read(ctx):
    return tracing.idle_share(ctx)
