"""End-to-end experiment runner, from the JAX package's
``core/experiment.py``: one ``run`` gives one method's row of a paper
table.

The DM is pre-trained once on the broad (union) pool with frozen-FM
conditioning, playing Stable Diffusion's role, then reused frozen by
OSCAR, FedCADO and FedDISC.  It is checkpointed in the reference's format
(``checkpoint/io.py``) under a tag of the config, so a later
``Experiment`` of the same config, in either package, loads it instead of
training again.  One ``SynthesisService`` serves D_syn to every
DM-assisted method, its rows cached and spilled to a ``SynthesisStore``
keyed by the DM tag and the seed.
"""
from __future__ import annotations

import hashlib
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.oscar import OscarConfig
from repro_torch.convert import dit_tree_from_state
from repro_torch.core.dm_baselines import run_fedcado, run_feddisc
from repro_torch.core.fl import run_fl, run_local_only
from repro_torch.core.oscar import run_oscar
from repro_torch.data.federated import make_federated_data
from repro_torch.diffusion.ddpm import pretrain_dm
from repro_torch.diffusion.dit import DiT, dit_from_tree
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.encoders.foundation import FrozenFM
from repro_torch.serve.service import SynthesisService
from repro_torch.serve.store import SynthesisStore
from repro_torch.serve.synthesis import SynthesisEngine
from repro_torch.utils import resolve_device

ALL_METHODS = ("local", "fedavg", "fedprox", "feddyn", "fedcado", "feddisc",
               "oscar")
DEFAULT_CACHE = Path(__file__).resolve().parents[3] / "build" / "dm_cache"


def dm_tag(ocfg: OscarConfig, steps: int) -> str:
    """The DM cache's tag, the reference's: ``md5(repr((data, diffusion,
    steps)))[:10]``; the port's config dataclasses print as the
    reference's, so the tags agree."""
    return "dm_" + hashlib.md5(
        repr((ocfg.data, ocfg.diffusion, steps)).encode()).hexdigest()[:10]


class Experiment:
    """Holds the dataset, the FM and the pre-trained DM across method
    runs, on ``device`` (the card unless the caller passes ``"cpu"``).

    Keys, as in the reference: ``self.key, kdm = split(PRNGKey(seed))``,
    the DM pre-trained from ``kdm``, and a method's run from
    ``fold_in(self.key, crc32(method))``.

    As in the reference, one ``SynthesisService`` over one engine
    (``self.service``, drain keys from ``fold_in(self.key, 0xD5)``) serves
    FedCADO, FedDISC and OSCAR, each drain keyed by the method's own key:
    a repeated run is served from the row cache, a larger
    ``samples_per_category`` generates only the top-up rows, and the
    cache spills to a ``SynthesisStore`` under ``cache_dir /
    f"{tag}_dsyn_s{seed}"`` (the DM's tag and the seed: another DM or seed
    gets another store), so a cold process against a warm store draws no
    sample.  ``tracer`` (an ``obs/trace.py::Tracer``) records the
    service's drains; tracing never changes D_syn.  ``hosts=H`` places
    every DM-assisted method's drains over H simulated hosts
    (``serve/topology.py``): the rows are keyed by identity, so D_syn
    does not depend on the host count beyond the denoiser's rounding at
    another batch size (on the card cuBLAS promises no row the same bits
    in a batch of another size)."""

    def __init__(self, ocfg: OscarConfig | None = None, *,
                 verbose: bool = True, pretrain_steps: int | None = None,
                 cache_dir: str | Path | None = None, device=None,
                 hosts: int | None = None, tracer=None):
        self.ocfg = ocfg or OscarConfig()
        self.verbose = verbose
        self.device = resolve_device(device)
        self.key, kdm = prng.split(prng.PRNGKey(self.ocfg.seed))
        t0 = time.perf_counter()
        self.data = make_federated_data(self.ocfg.data)
        self.fm = FrozenFM(self.ocfg.encoding_dim)
        if self.data.pool_images is not None:
            # the DM pre-trains on the broad pool (SD's web-scale analogue),
            # independent of what the clients hold
            union_x = self.data.pool_images
            union_lab = self.data.pool_labels
            union_dom = self.data.pool_domains
        else:
            union_x = self.data.client_images.reshape(
                -1, *self.data.client_images.shape[2:])
            union_lab = self.data.client_labels.reshape(-1)
            union_dom = self.data.client_domains.reshape(-1)
        with torch.inference_mode():
            union_y = self.fm(torch.as_tensor(
                union_x, device=self.device)).cpu().numpy()
        self._say(f"[exp] data ready ({union_x.shape[0]} train images) "
                  f"{time.perf_counter() - t0:.1f}s")

        dc, data_cfg = self.ocfg.diffusion, self.ocfg.data
        size, ch = data_cfg.image_size, data_cfg.channels
        steps = pretrain_steps or dc.pretrain_steps
        self.tag = dm_tag(self.ocfg, steps)
        cache_dir = Path(cache_dir or DEFAULT_CACHE)
        cpath = cache_dir / self.tag
        self.sched = make_schedule(dc.train_timesteps, dc.schedule,
                                   device=self.device)
        if ckpt.exists(cpath):
            # the template gives load_pytree the tree's shapes, no values
            shapes = DiT(dc, size, ch, device="meta").state_dict()
            template = dit_tree_from_state(
                {k: torch.empty(v.shape) for k, v in shapes.items()})
            tree = ckpt.load_pytree(template, cpath)
            self.dm = dit_from_tree(tree, dc, size, ch, device=self.device)
            self.dm_losses = []
            self._say(f"[exp] frozen DM loaded from cache {self.tag}")
        else:
            t0 = time.perf_counter()
            self._say("[exp] pre-training DM...")
            C = self.data.num_categories
            groups = union_dom.astype(np.int64) * C + union_lab
            self.dm, self.sched, self.dm_losses = pretrain_dm(
                kdm, dc, union_x, union_y, image_size=size, channels=ch,
                steps=steps, log_every=200 if verbose else 0, groups=groups,
                device=self.device)
            ckpt.save_pytree(dit_tree_from_state(self.dm.state_dict()),
                             cpath, meta={"steps": steps, "tag": self.tag})
            self._say(f"[exp] DM pre-trained in "
                      f"{time.perf_counter() - t0:.1f}s (cached as "
                      f"{self.tag})")

        # one service for every DM-assisted method; the store's root folds
        # in the seed, since D_syn depends on the drain keys drawn from it
        self.engine = SynthesisEngine(self.dm, self.sched, image_size=size,
                                      channels=ch, hosts=hosts, tracer=tracer)
        self.service = SynthesisService(
            self.engine, key=prng.fold_in(self.key, 0xD5),
            store=SynthesisStore(
                cache_dir / f"{self.tag}_dsyn_s{self.ocfg.seed}"))
        self.tracer = self.engine.tracer

    def _say(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def run(self, method: str, *, classifier: str | None = None,
            rounds: int = 10, samples_per_category: int | None = None,
            **kw) -> dict:
        """One method's metrics (``avg`` and ``client1`` …), with
        ``upload_params``, ``method`` and ``wall_s``; ``**kw`` goes to the
        FL baselines and ``run_oscar``."""
        method = method.lower()
        classifier = classifier or self.ocfg.classifier
        key = prng.fold_in(self.key, zlib.crc32(method.encode()))
        dm_args = (key, self.ocfg, self.data, self.dm, self.sched)
        t0 = time.perf_counter()
        if method == "local":
            _, metrics, upload = run_local_only(key, self.data,
                                                name=classifier,
                                                device=self.device)
        elif method in ("fedavg", "fedprox", "feddyn"):
            _, metrics, upload = run_fl(key, self.data, name=classifier,
                                        method=method, rounds=rounds,
                                        device=self.device, **kw)
        elif method == "fedcado":
            _, metrics, upload, _ = run_fedcado(
                *dm_args, classifier=classifier,
                samples_per_category=samples_per_category,
                service=self.service)
        elif method == "feddisc":
            _, metrics, upload, _ = run_feddisc(
                *dm_args, self.fm, classifier=classifier,
                samples_per_category=samples_per_category,
                service=self.service)
        elif method == "oscar":
            # an engine the caller passes beats the shared service
            res = run_oscar(*dm_args, self.fm, classifier=classifier,
                            samples_per_category=samples_per_category,
                            engine=kw.pop("engine", None),
                            service=kw.pop("service", self.service), **kw)
            metrics, upload = res.metrics, res.upload_per_client
        else:
            raise ValueError(method)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        out = dict(metrics)
        out["upload_params"] = upload
        out["method"] = method
        out["wall_s"] = round(time.perf_counter() - t0, 1)
        self._say(f"[exp] {method:8s} avg={out['avg'] * 100:5.2f}% "
                  f"upload={upload / 1e3:.1f}k params ({out['wall_s']}s)")
        return out
