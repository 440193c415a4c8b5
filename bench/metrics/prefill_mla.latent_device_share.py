"""prefill_mla.latent_device_share: device time inside the ``mla_latent``
region the harness wraps around ``models/mla.py::mla_latent`` (latent
attention's down projection, norm, up projection, rope and k assembly),
over all device time in the traced window, in percent."""

REGION = ("mla_latent", "repro_torch.models.mla", "mla_latent")


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["busy_s"] or not tr["region_s"].get("mla_latent"):
        return None
    return 100.0 * tr["region_s"]["mla_latent"] / tr["busy_s"]
