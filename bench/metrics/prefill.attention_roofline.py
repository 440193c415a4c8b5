"""prefill.attention_roofline: the attention's least time (the larger of its
operations at the dtype's peak and its bytes at the HBM rate, counted from
each call's shapes) over the device time of everything launched inside the
``attention`` region the harness wraps around
``kernels/flash_attention/ops.py::flash_attention``, in percent."""
from bench.yardstick import attention

REGION = attention.REGION


def read(ctx):
    return attention.roofline_share(ctx)
