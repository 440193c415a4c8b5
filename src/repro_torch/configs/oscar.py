"""OSCAR experiment configuration — the paper's own hyper-parameters.

Field for field the same as the JAX package's ``configs/oscar.py`` (same
names, same defaults), kept as a copy so the port never imports it.

Paper settings (Sections IV–V): guidance scale s=7.5, T=50 sampling steps,
10 images generated per (client, category) by default (Table III sweeps
10..50), 6 clients (= #domains), 30 images/category/client for Table I,
ResNet-18 global classifier, single communication round, 512-d CLIP
encodings (so each client uploads C × 512 floats).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataConfig:
    num_categories: int = 10          # paper: 60 (NICO++) / 90 / 120; scaled
    num_domains: int = 6              # paper: 6 → one domain per client
    image_size: int = 16              # paper: 224; scaled down
    channels: int = 3
    train_per_cat_dom: int = 30       # images per (category, domain) train
    test_per_cat_dom: int = 8
    # Size of the DM pre-training pool per (category, domain) — disjoint
    # from client data.  0 = pre-train on the union of client shards.
    pretrain_pool_per_cat_dom: int = 0
    seed: int = 0


@dataclass(frozen=True)
class DiffusionConfig:
    # DiT denoiser (stands in for Stable Diffusion)
    d_model: int = 128
    num_layers: int = 4
    num_heads: int = 4
    patch: int = 4
    cond_dim: int = 512               # CLIP text-encoding dim (paper: 512)
    train_timesteps: int = 1000
    sample_timesteps: int = 50        # paper: T = 50
    # The paper fixes s=7.5 for Stable Diffusion; the scaled-down DM
    # saturates at that strength and s=2.0 is the tuned equivalent.
    guidance_scale: float = 2.0
    paper_guidance_scale: float = 7.5
    cond_drop_prob: float = 0.1       # classifier-free training drop (Ho & Salimans)
    group_cond_prob: float = 0.4      # train on ȳ group means
    pretrain_steps: int = 2500
    batch_size: int = 128
    lr: float = 3e-4
    schedule: str = "cosine"
    # Kept for parity with the reference config.  The port picks its
    # kernels by device (CUDA tensors always take them), whatever this says.
    use_pallas: bool = False
    # bf16 activations on the QKV/MLP matmuls: not ported yet, and the
    # denoiser raises NotImplementedError when it is set.
    bf16_act: bool = False


@dataclass(frozen=True)
class OscarConfig:
    data: DataConfig = field(default_factory=DataConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    num_clients: int = 6              # paper: 6
    encoding_dim: int = 512           # paper: 512 params per category
    samples_per_category: int = 10    # paper: 10 (Table III sweeps)
    classifier: str = "resnet18"      # paper main results
    classifier_steps: int = 400
    classifier_lr: float = 1e-3
    classifier_batch: int = 64
    seed: int = 0
