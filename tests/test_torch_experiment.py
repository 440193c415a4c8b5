"""The port's ``Experiment`` against the JAX package's, on a tiny config on
the CPU: its keys, its DM cache tag, the data and encodings it pre-trains
on, the pre-trained DM itself (two steps, against the reference's
``pretrain_dm`` from the same key), the checkpoint cache in both
directions, and one run of OSCAR and of an FL baseline.

The DM trains for two steps only, so the methods' accuracies mean
nothing here: what a trained DM gives is ``chip_smoke.py`` phase 10's.
"""
import hashlib
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import oscar as jconfigs
from repro.data.federated import make_federated_data as jmake_data
from repro.diffusion import ddpm as jddpm
from repro.encoders.foundation import FrozenFM as JFrozenFM
from repro_torch.configs import oscar as tconfigs
from repro_torch.convert import dit_state_from_jax
from repro_torch.core import experiment as texp
from repro_torch.encoders.foundation import FrozenFM
from torch_one_thread import one_thread  # noqa: F401

TINY = dict(
    data=dict(num_categories=3, num_domains=3, train_per_cat_dom=4,
              test_per_cat_dom=2, pretrain_pool_per_cat_dom=4),
    diffusion=dict(d_model=32, num_layers=1, num_heads=2, pretrain_steps=2,
                   batch_size=16, sample_timesteps=4),
    top=dict(classifier="vit_b16", classifier_steps=4, samples_per_category=2,
             seed=3))
PAPER = dict(
    data=dict(num_categories=10, train_per_cat_dom=10, test_per_cat_dom=8,
              pretrain_pool_per_cat_dom=120),
    diffusion=dict(d_model=144, pretrain_steps=6000, batch_size=128),
    top=dict(classifier_steps=400, samples_per_category=30))
TOL_ENC = 1e-5          # the FM's encodings, as test_torch_train gates them
TOL_LOSS = 1e-5         # test_torch_ddpm's loss gate
# the DiT after two AdamW steps.  adaLN-zero leaves step 2's gradients,
# all but patch_out's, at ~1e-9, the scale of Adam's eps = 1e-8, where an
# update lr·g/(|g| + eps) turns the gradients' fp32 rounding into a
# visible move: measured 1.16e-6 (blocks.0.mod.weight, an element of
# 7.3e-5), against 6e-4 for two steps of lr = 3e-4
TOL_DM = 2e-6


def _cfg(mod, preset):
    return mod.OscarConfig(
        data=mod.DataConfig(**preset["data"]),
        diffusion=mod.DiffusionConfig(**preset["diffusion"]), **preset["top"])


def _state_err(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.fixture(scope="module")
def reference():
    """What the reference's ``Experiment.__init__`` computes before its
    serving layer: the keys, the pool, its encodings and groups, and the
    DM pre-trained from ``kdm``.  The DM trains on the port's encodings
    (within ``TOL_ENC`` of the reference's, tested apart), so that the DM
    gate holds the pretraining alone."""
    cfg = _cfg(jconfigs, TINY)
    key, kdm = jax.random.split(jax.random.PRNGKey(cfg.seed))
    data = jmake_data(cfg.data)
    y = np.asarray(JFrozenFM(cfg.encoding_dim)(data.pool_images))
    with torch.inference_mode():
        y_port = FrozenFM(cfg.encoding_dim)(
            torch.as_tensor(data.pool_images, device="cpu")).numpy()
    groups = (data.pool_domains.astype(np.int64) * cfg.data.num_categories
              + data.pool_labels)
    params, _, losses = jddpm.pretrain_dm(
        kdm, cfg.diffusion, data.pool_images, y_port, image_size=16,
        channels=3, steps=cfg.diffusion.pretrain_steps, groups=groups)
    return dict(cfg=cfg, key=np.asarray(key), data=data, y=y, y_port=y_port,
                params=params, losses=losses)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    cache = tmp_path_factory.mktemp("dm")
    exp = texp.Experiment(_cfg(tconfigs, TINY), verbose=False,
                          cache_dir=cache, device="cpu")
    return exp, cache


def test_keys_data_and_pretrained_dm_are_the_references(reference,
                                                        experiment):
    exp, _ = experiment
    ref = reference
    assert np.array_equal(exp.key, ref["key"])
    for name in ("client_images", "client_labels", "client_domains",
                 "test_images", "test_labels", "pool_images", "pool_labels",
                 "pool_domains"):
        assert np.array_equal(getattr(exp.data, name),
                              getattr(ref["data"], name)), name
    # the DM trained on the reference's pool, encodings and groups, from
    # the reference's kdm
    assert len(exp.dm_losses) == 2 and not exp.dm.plain
    assert max(abs(a - b) for (_, a), (_, b) in zip(exp.dm_losses,
                                                    ref["losses"])) < TOL_LOSS
    want = dit_state_from_jax(jax.tree.map(np.asarray, ref["params"]))
    assert _state_err(want, exp.dm.state_dict()) <= TOL_DM


def test_the_cache_crosses_between_the_packages(reference, experiment,
                                                tmp_path):
    exp, cache = experiment
    assert (cache / f"{exp.tag}.npz").exists()
    # the port's own checkpoint loads back bit for bit, untrained
    again = texp.Experiment(exp.ocfg, verbose=False, cache_dir=cache,
                            device="cpu")
    assert again.dm_losses == [] and again.tag == exp.tag
    assert _state_err(exp.dm.state_dict(), again.dm.state_dict()) == 0
    # the reference's DM, written where the reference's Experiment writes
    # it (its tag), loads into the port equal to convert's weights
    jckpt.save_pytree(reference["params"], tmp_path / exp.tag,
                      meta={"steps": 2, "tag": exp.tag})
    loaded = texp.Experiment(exp.ocfg, verbose=False, cache_dir=tmp_path,
                             device="cpu")
    want = dit_state_from_jax(jax.tree.map(np.asarray, reference["params"]))
    assert loaded.dm_losses == []
    assert _state_err(want, loaded.dm.state_dict()) == 0


def test_each_method_runs_from_the_references_key(reference, experiment,
                                                  monkeypatch):
    exp, _ = experiment
    seen = {}

    def fake(name):
        def run(key, *args, **kwargs):
            seen[name] = np.asarray(key)
            out = ({"avg": 0.5}, 7)
            return (None, *out) if name in ("local", "fl") else \
                (None, *out, None)
        return run

    for name in ("run_local_only", "run_fl", "run_fedcado", "run_feddisc"):
        monkeypatch.setattr(texp, name, fake(name.split("_")[1]))
    for method, slot in (("local", "local"), ("FedProx", "fl"),
                         ("fedcado", "fedcado"), ("feddisc", "feddisc")):
        out = exp.run(method)
        want = jax.random.fold_in(jax.numpy.asarray(reference["key"]),
                                  zlib.crc32(method.lower().encode()))
        assert np.array_equal(seen[slot], np.asarray(want)), method
        assert out["method"] == method.lower()
        assert out["upload_params"] == 7
    with pytest.raises(ValueError):
        exp.run("fedsgd")
    assert texp.ALL_METHODS == ("local", "fedavg", "fedprox", "feddyn",
                                "fedcado", "feddisc", "oscar")


def test_oscar_and_fedavg_run_end_to_end(experiment):
    exp, _ = experiment
    C = exp.ocfg.data.num_categories
    o = exp.run("oscar")
    f = exp.run("fedavg", rounds=1, local_steps=2)
    for res in (o, f):
        clients = [k for k in res if k.startswith("client")]
        assert len(clients) == exp.data.client_images.shape[0]
        assert all(0.0 <= res[k] <= 1.0 for k in clients + ["avg"])
        assert res["wall_s"] >= 0
    assert o["upload_params"] == C * 512 < f["upload_params"]
    assert not exp.dm.plain


@pytest.mark.usefixtures("one_thread")
def test_dm_methods_share_one_service_its_cache_and_its_store(reference,
                                                             experiment):
    """One service over one engine serves the DM-assisted methods, its
    drain keys from ``fold_in(key, 0xD5)`` and its store under the DM's
    tag and the seed, as the reference's: a second run of OSCAR or
    FedDISC is served from the row cache with no wave and the same
    accuracy, and a second ``Experiment`` on the same ``cache_dir`` serves
    both from the store with no wave."""
    exp, cache = experiment
    key = jax.random.fold_in(jax.numpy.asarray(reference["key"]), 0xD5)
    assert np.array_equal(exp.service._base_key, np.asarray(key))
    assert exp.service.engine is exp.engine
    assert exp.service.store.root == cache / f"{exp.tag}_dsyn_s3"
    runs = {}
    for i in range(3):
        # the cold Experiment opens the store after the runs have filled it
        e = exp if i < 2 else texp.Experiment(exp.ocfg, verbose=False,
                                              cache_dir=cache, device="cpu")
        for m in ("oscar", "feddisc"):
            before = e.engine.stats
            out = e.run(m)
            after = e.engine.stats
            runs.setdefault(m, []).append(
                (out["avg"], after["waves"] - before["waves"],
                 after["cache_hits"] - before["cache_hits"],
                 after["store_hits"] - before["store_hits"]))
    n = int(exp.data.client_labels.shape[0] * 3 * 2)   # present pairs x 2
    for m, ((acc, waves, hits, _), again, cold) in runs.items():
        # the module's end-to-end test may have run OSCAR on it already
        assert (waves >= 1 and hits == 0) or (m == "oscar" and hits == n), m
        assert again == (acc, 0, n, 0), m
        assert cold == (acc, 0, n, n), m


def test_encodings_the_dm_trains_on_are_the_references(reference):
    err = float(np.abs(reference["y_port"] - reference["y"]).max())
    assert err < TOL_ENC


@pytest.mark.parametrize("preset", [None, TINY, PAPER],
                         ids=["default", "tiny", "paper"])
def test_dm_tag_equals_the_references(preset):
    ref = (jconfigs.OscarConfig() if preset is None
           else _cfg(jconfigs, preset))
    port = (tconfigs.OscarConfig() if preset is None
            else _cfg(tconfigs, preset))
    for a, b in ((ref.data, port.data), (ref.diffusion, port.diffusion)):
        assert repr(a) == repr(b)
    steps = port.diffusion.pretrain_steps
    want = "dm_" + hashlib.md5(repr((ref.data, ref.diffusion, steps))
                               .encode()).hexdigest()[:10]
    assert texp.dm_tag(port, steps) == want
