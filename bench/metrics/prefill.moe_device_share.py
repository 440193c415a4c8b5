"""prefill.moe_device_share: device time inside the ``moe`` region the
harness wraps around ``models/moe.py::moe_dense``, over all device time in
the traced window, in percent."""

REGION = ("moe", "repro_torch.models.moe", "moe_dense")


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["busy_s"] or tr["region_s"].get("moe") is None:
        return None
    return 100.0 * tr["region_s"]["moe"] / tr["busy_s"]
