"""OSCAR — One-Shot federated learning with ClAssifier-fRee diffusion
models (the paper's §IV pipeline), client encodings to D_syn:

  (1) each client encodes its images with the frozen FM (Eq. 6) and
      mean-pools per category (Eq. 7)                     [client side]
  (2) each client uploads its C × 512 category encodings  [ONE round]
  (3) the server runs classifier-free guided sampling (Eq. 8/9) to
      synthesise ``k_samples`` images per uploaded (client, category)
      encoding → D_syn.

Step (4), training the global classifier on D_syn (``run_oscar``), is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.diffusion.dit import DiT
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.encoders.foundation import FrozenFM, category_encodings
from repro_torch.serve.synthesis import SynthesisEngine
from repro_torch.utils import resolve_device


@torch.inference_mode()
def client_encodings(fm: FrozenFM, data, *, device=None):
    """Steps (1)+(2): per-client per-category mean encodings, computed on
    ``device`` (the card unless the caller passes ``"cpu"``).  Returns the
    upload as host arrays: enc (R, C, dim) float32, present (R, C) bool."""
    device = resolve_device(device)
    R = data.client_images.shape[0]
    C = data.num_categories
    enc = np.zeros((R, C, fm.dim), np.float32)
    present = np.zeros((R, C), bool)
    for r in range(R):
        m, p = category_encodings(
            fm, torch.as_tensor(data.client_images[r], device=device),
            data.client_labels[r], C)
        enc[r] = m.cpu().numpy()
        present[r] = p.cpu().numpy()
    return enc, present


def synthesize(key, model: DiT, sched: NoiseSchedule, encodings, present,
               k_samples: int, *, image_size: int, channels: int = 3,
               guidance: float | None = None, num_steps: int | None = None,
               wave_size: int = 128, ragged: bool = False,
               compaction: int | str | None = None):
    """Step (3): server-side D_syn generation on the model's device, from
    the threefry ``key``.

    Every present (client, category) encoding becomes one request of
    ``k_samples`` rows, in (client, category) order, and a
    ``SynthesisEngine`` drains them: near-uniform waves of at most
    ``wave_size`` rows, ragged waves with ``ragged=True``, and compacted
    ragged waves with ``compaction`` (``"full"``, ``"auto"`` or an int K).
    Returns (images (N, H, W, C) float32, labels (N,) int64), both on the
    model's device; an all-absent ``present`` gives empty tensors."""
    device = model.null_y.device
    eng = SynthesisEngine(model, sched, image_size=image_size,
                          channels=channels, wave_size=wave_size,
                          ragged=ragged, compaction=compaction)
    R, C, _ = encodings.shape
    rids, cats = [], []
    for r in range(R):
        for c in range(C):
            if present[r, c]:
                rids.append(eng.submit(encodings[r, c], c, k_samples,
                                       guidance=guidance,
                                       num_steps=num_steps))
                cats.append(c)
    if not rids:
        return (torch.zeros((0, image_size, image_size, channels),
                            device=device),
                torch.zeros((0,), dtype=torch.int64, device=device))
    out = eng.run(key)
    labels = np.repeat(np.asarray(cats, np.int64), k_samples)
    return (torch.cat([out[rid] for rid in rids]),
            torch.as_tensor(labels, device=device))
