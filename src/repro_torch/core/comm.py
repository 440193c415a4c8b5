"""Communication accounting — paper Table IV / Fig. 1.

``upload_params`` computes the per-client upload for OUR experiment scale;
``paper_scale_table4`` reproduces the paper's published numbers from its
constants (ResNet-18 = 11.69M params, 20 FedAvg rounds, C≈60 categories,
512-d CLIP encodings) to validate the accounting model itself.

A copy of the JAX package's ``core/comm.py``, which is pure Python; the
port keeps its own so that it never imports the reference.
"""
from __future__ import annotations

RESNET18_PARAMS = 11_689_512          # torchvision ResNet-18, the paper's unit
PAPER_FEDAVG_ROUNDS = 20
PAPER_ENC_DIM = 512


def upload_params(method: str, *, num_categories: int, enc_dim: int = 512,
                  clf_params: int = 0, rounds: int = 1,
                  n_prototypes: int = 4) -> int:
    """Parameters uploaded by EACH client for a full run of ``method``."""
    method = method.lower()
    if method == "local":
        return 0
    if method in ("fedavg", "fedprox", "feddyn"):
        return clf_params * rounds
    if method == "fedcado":
        return clf_params                       # one-shot classifier upload
    if method == "feddisc":
        return (2 + n_prototypes) * num_categories * enc_dim
    if method == "oscar":
        return num_categories * enc_dim         # C × 512 (paper §VI-d)
    raise ValueError(method)


def paper_scale_table4() -> dict:
    """Reproduce Table IV (params uploaded per client, in millions)."""
    C = 60
    vals = {
        "Local": 0.0,
        "FedAvg": RESNET18_PARAMS * PAPER_FEDAVG_ROUNDS / 1e6,
        "FedCADO": RESNET18_PARAMS / 1e6,
        "FedDISC": 4.23,   # published value; feature-stat upload at CLIP scale
        "OSCAR": C * PAPER_ENC_DIM / 1e6,
    }
    return vals


def reduction_vs_sota(oscar: float, baselines: dict) -> float:
    """OSCAR's claimed ≥99% upload reduction vs the best DM-assisted SOTA."""
    sota = min(v for k, v in baselines.items()
               if k.lower() in ("fedcado", "feddisc"))
    return 1.0 - oscar / sota
