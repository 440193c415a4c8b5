"""The one generator of traffic: it reads a mix's parameters (a JSON file
under ``bench/traffic/``) and the run's seed, and gives the requests.

Every seed gets the same set of sizes and arrivals; the seed changes only
the values (encodings, token ids) and the order inside a batch.
Two kinds:

* ``synthesis``: upload requests of federation rounds.  Request i belongs
  to round i // (clients · categories), one (client, category) each, with
  ``images_per_request`` images at the mix's ``guidance`` and ``steps``,
  and an encoding of its own: a unit vector drawn from the seed.
* ``prompts``: offline batches.  Batch b holds ``count`` prompts of each
  ``length`` in ``batch``, in an order drawn from the seed, with token ids
  uniform over the vocabulary.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    """The mix ``name`` (``bench/traffic/<name>.json``)."""
    spec = json.loads((ROOT / f"{name}.json").read_text())
    if spec.get("kind") not in ("synthesis", "prompts"):
        raise ValueError(f"traffic {name}: unknown kind {spec.get('kind')}")
    return spec


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


@dataclass(frozen=True)
class Upload:
    index: int
    round: int
    client: int
    category: int
    count: int
    guidance: float
    steps: int
    encoding: np.ndarray          # (cond_dim,) float32, unit norm


def upload(spec: dict, seed: int, i: int, cond_dim: int) -> Upload:
    """Request ``i`` of a ``synthesis`` mix."""
    r, j = divmod(i, spec["clients"] * spec["categories"])
    e = _rng(seed, 2, i).standard_normal(cond_dim).astype(np.float32)
    return Upload(index=i, round=r, client=j // spec["categories"],
                  category=j % spec["categories"],
                  count=spec["images_per_request"],
                  guidance=float(spec["guidance"]), steps=int(spec["steps"]),
                  encoding=e / np.linalg.norm(e))


@dataclass(frozen=True)
class Prompt:
    batch: int
    position: int                 # in the batch's submission order
    tokens: np.ndarray            # (length,) int32


def prompt_batch(spec: dict, seed: int, b: int, vocab: int) -> list[Prompt]:
    """Batch ``b`` of a ``prompts`` mix, in submission order."""
    lengths = [int(n) for n, c in spec["batch"] for _ in range(int(c))]
    order = _rng(seed, 3, b).permutation(len(lengths))
    rng = _rng(seed, 4, b)
    out = []
    for pos, k in enumerate(order):
        out.append(Prompt(b, pos, rng.integers(0, vocab, lengths[k],
                                               dtype=np.int32)))
    return out
