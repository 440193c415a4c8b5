"""prefill_mla.attention_roofline: latent attention's least time (the larger
of its operations at the dtype's peak and its bytes at the HBM rate, q·k at
the call's head dim and p·v at the configuration's ``v_head_dim``,
``yardstick/mla.py``) over the device time of everything launched inside
the ``attention`` region the harness wraps around
``kernels/flash_attention/ops.py::flash_attention``, in percent."""
from bench.yardstick import mla

REGION = mla.REGION


def read(ctx):
    return mla.roofline_share(ctx)
