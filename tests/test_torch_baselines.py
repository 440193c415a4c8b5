"""The paper's other methods, the port against the JAX package: the FL
baselines (FedAvg, FedProx, FedDyn, with full and half participation, and
Local), the DM-assisted ones (FedCADO, FedDISC) and the engine's 2-D
requests that FedDISC submits.

Both packages start from the same seeded classifier weights
(``test_torch_train.inject_init``) and the same threefry keys.  The
classifier is the ViT: its gelu, softmax and LayerNorm are smooth, so two
backends' gradients differ by rounding only (a ReLU net's jump at its
kinks, ``test_torch_train``'s docstring); FedCADO's guidance gradients and
both methods' global models also train on D_syn, which already differs
between the packages by up to the 5e-4 sampler gate.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.oscar import DataConfig as JDataConfig
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.configs.oscar import OscarConfig as JOscarConfig
from repro.core import classifier_train as jct
from repro.core import dm_baselines as jdm
from repro.core import fl as jfl
from repro.diffusion import schedule as jsched
from repro.encoders.foundation import FrozenFM as JFrozenFM
from repro.serve.synthesis import SynthesisEngine as JEngine
from repro_torch import prng
from repro_torch.configs.oscar import DataConfig, DiffusionConfig, OscarConfig
from repro_torch.core import classifier_train as tct
from repro_torch.core import comm
from repro_torch.core import dm_baselines as tdm
from repro_torch.core import fl as tfl
from repro_torch.data.federated import make_federated_data
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tsched
from repro_torch.encoders.foundation import FrozenFM
from repro_torch.models import classifiers as tclf
from repro_torch.serve.synthesis import STAT_KEYS, SynthesisEngine
from test_torch_dit import perturbed_params, port_model
from test_torch_train import inject_init, max_param_err
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "vit_b16"
DC = dict(d_model=32, num_layers=1, num_heads=2, train_timesteps=16,
          sample_timesteps=4)
DATA = dict(num_categories=3, num_domains=2, train_per_cat_dom=3,
            test_per_cat_dom=4)
OSCAR = dict(samples_per_category=3, classifier_steps=2, classifier_batch=8)
# FL: every client's local SGD and the server's mean in fp32, the
# reference's vmapped over clients, the port's a loop; 2 rounds of 2 steps
TOL_FL = 1e-5
# D_syn at smoke depth (the sampler gate) and a global model trained two
# steps on it (run_oscar's gate, test_torch_train)
TOL_DSYN = 5e-4
TOL_DM_PARAMS = 1e-4


@pytest.fixture(scope="module")
def data():
    return make_federated_data(DataConfig(**DATA))


@pytest.fixture(scope="module")
def server():
    jdc = JDiffusionConfig(**DC)
    params = perturbed_params(jdc, 16)
    return (JOscarConfig(data=JDataConfig(**DATA), diffusion=jdc, **OSCAR),
            params, jsched.make_schedule(16),
            OscarConfig(data=DataConfig(**DATA),
                        diffusion=DiffusionConfig(**DC), **OSCAR),
            port_model(params, DC, 16),
            tsched.make_schedule(16, device="cpu"))


# -- FL -------------------------------------------------------------------------

@pytest.mark.parametrize("participation", [1.0, 0.5])
@pytest.mark.parametrize("method", ["fedavg", "fedprox", "feddyn"])
def test_run_fl_matches_reference(data, monkeypatch, method, participation):
    inject_init(monkeypatch, jfl)
    key = jax.random.PRNGKey(41)
    kw = dict(name=NAME, method=method, rounds=2, local_steps=2, batch=8,
              eval_every=1, participation=participation)
    ref_p, ref_m, ref_up = jfl.run_fl(key, data, **kw)
    got_p, got_m, got_up = tfl.run_fl(np.asarray(key), data, device="cpu",
                                      **kw)
    assert max_param_err(ref_p, got_p, NAME) < TOL_FL
    assert got_m == ref_m and len(got_m["history"]) == 2
    n_params = sum(p.numel() for p in got_p.parameters())
    assert got_up == ref_up
    if participation == 1.0:
        assert got_up == comm.upload_params(method, num_categories=3,
                                            clf_params=n_params, rounds=2)


def test_run_local_only_matches_reference(data, monkeypatch):
    inject_init(monkeypatch, jfl)
    key = jax.random.PRNGKey(43)
    _, ref_m, ref_up = jfl.run_local_only(key, data, name=NAME, steps=2,
                                          batch=8)
    got, got_m, got_up = tfl.run_local_only(np.asarray(key), data,
                                            name=NAME, steps=2, batch=8,
                                            device="cpu")
    assert got is None and got_up == ref_up == 0
    assert got_m == ref_m
    assert sorted(got_m) == ["avg", "client1", "client2"]


def test_local_sgd_pairs_h_and_global_by_name(data):
    """FedDyn's h update pairs each parameter with its own h and global
    value; handing the dicts in another order changes nothing."""
    model = tclf.init_classifier(prng.PRNGKey(0), NAME, 3, device="cpu")
    g = tct.param_dict(model)
    h = {k: 0.01 * torch.ones_like(v) for k, v in g.items()}
    images, labels = tct.as_data(data.client_images[0],
                                 data.client_labels[0], "cpu")
    idx = tct.batch_indices(prng.PRNGKey(1), 2, 4, len(images), "cpu")
    kw = dict(lr=0.05, mu=0.1, alpha=0.1)
    p1, h1 = tfl._local_sgd(model, g, h, images, labels, idx, **kw)
    rev = lambda d: dict(reversed(list(d.items())))
    p2, h2 = tfl._local_sgd(model, rev(g), rev(h), images, labels, idx,
                            **kw)
    for k in g:
        assert torch.equal(p1[k], p2[k]) and torch.equal(h1[k], h2[k])
        assert torch.equal(h1[k], h[k] - 0.1 * (p1[k] - g[k]))


# -- DM-assisted baselines ------------------------------------------------------

def test_run_fedcado_matches_reference(data, server, monkeypatch):
    jocfg, params, jsch, tocfg, model, sched = server
    inject_init(monkeypatch, jct, jdm)
    key = jax.random.PRNGKey(47)
    ref_p, ref_m, ref_up, (ref_x, ref_y) = jdm.run_fedcado(
        key, jocfg, data, params, jsch, classifier=NAME, local_steps=2)
    got_p, got_m, got_up, (x, y) = tdm.run_fedcado(
        np.asarray(key), tocfg, data, model, sched, classifier=NAME,
        local_steps=2)
    assert got_up == ref_up == comm.upload_params(
        "fedcado", num_categories=3,
        clf_params=sum(p.numel() for p in got_p.parameters()))
    assert np.array_equal(y.numpy(), ref_y) and x.shape == (18, 16, 16, 3)
    assert float(np.abs(ref_x).max()) > 1e-2
    assert float(np.max(np.abs(x.numpy() - ref_x))) < TOL_DSYN
    assert max_param_err(ref_p, got_p, NAME) < TOL_DM_PARAMS
    assert got_m == ref_m


@pytest.mark.parametrize("mode", [dict(), dict(ragged=True),
                                  dict(compaction="full")],
                         ids=["grouped", "ragged", "compacted"])
def test_run_feddisc_matches_reference(data, server, monkeypatch, mode):
    jocfg, params, jsch, tocfg, model, sched = server
    inject_init(monkeypatch, jct, jdm)
    key = jax.random.PRNGKey(53)
    ref_p, ref_m, ref_up, (ref_x, ref_y) = jdm.run_feddisc(
        key, jocfg, data, params, jsch, JFrozenFM(), classifier=NAME,
        **mode)
    eng = SynthesisEngine(model, sched, image_size=16)
    got_p, got_m, got_up, (x, y) = tdm.run_feddisc(
        np.asarray(key), tocfg, data, model, sched, FrozenFM(),
        classifier=NAME, engine=eng, **mode)
    assert eng.ragged == bool(mode) and eng.stats["generated"] == 18
    assert got_up == ref_up == comm.upload_params("feddisc",
                                                  num_categories=3)
    assert np.array_equal(y.numpy(), ref_y) and x.shape == (18, 16, 16, 3)
    assert float(np.abs(ref_x).max()) > 1e-2
    assert float(np.max(np.abs(x.numpy() - ref_x))) < TOL_DSYN
    assert max_param_err(ref_p, got_p, NAME) < TOL_DM_PARAMS
    assert got_m == ref_m


# -- the engine's 2-D requests --------------------------------------------------

@pytest.mark.parametrize("mode", [dict(), dict(ragged=True),
                                  dict(compaction="full")],
                         ids=["grouped", "ragged", "compacted"])
def test_2d_requests_match_reference_engine(server, mode):
    """2-D requests (one distinct row per sample) beside 1-D ones, split
    across waves of 8 rows: the same rows, waves and counters as the
    reference's engine, images within the gate."""
    jocfg, params, jsch, tocfg, model, sched = server
    rng = np.random.default_rng(5)
    reqs = [rng.standard_normal((5, 512)).astype(np.float32),
            rng.standard_normal(512).astype(np.float32),
            rng.standard_normal((7, 512)).astype(np.float32)]
    ref = JEngine(params, jocfg.diffusion, jsch, image_size=16, wave_size=8,
                  **mode)
    port = SynthesisEngine(model, sched, image_size=16, wave_size=8, **mode)
    for i, enc in enumerate(reqs):
        count = 4 if enc.ndim == 1 else None
        assert port.submit(enc, i, count) == ref.submit(enc, i, count)
    key = jax.random.PRNGKey(3)
    want = ref.run(key)
    got = port.run(np.asarray(key))
    for rid, x in got.items():
        assert x.shape == want[rid].shape
        assert float(np.max(np.abs(x.numpy() - np.asarray(want[rid])))) \
            < TOL_DSYN
    for k in ("waves", "generated", "padded", "row_iters_scheduled"):
        assert port.stats[k] == ref.stats[k], k


def test_2d_request_rows_are_sliced_in_wave_order(server):
    """A 2-D request's rows go to the waves in order, each row to its own
    sample: a grouped wave is ``sample_cfg`` over the wave's rows from
    the wave key, a ragged wave ``sample_cfg_ragged`` over them with row
    i of request rid keyed ``fold_in(fold_in(key, rid), i)``, bit for bit.
    Compacted waves give the ragged rows within the packing gate (a batch
    of another size rounds the denoiser's sums otherwise)."""
    *_, model, sched = server
    enc = np.random.default_rng(6).standard_normal((10, 512)) \
        .astype(np.float32)
    one = np.random.default_rng(7).standard_normal(512).astype(np.float32)
    key = prng.PRNGKey(8)
    # waves of 8: wave 0 = 2-D rows 0-7, wave 1 = rows 8-9 and the 1-D
    # request's 4 rows, padded to 8 by repeating the last
    cond = np.concatenate([enc, np.repeat(one[None], 4, 0)])
    waves = [cond[:8], np.concatenate([cond[8:], cond[-1:].repeat(2, 0)])]
    outs = {}
    for name, mode in (("grouped", {}), ("ragged", dict(ragged=True)),
                       ("compacted", dict(compaction="full"))):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              **mode)
        assert eng.submit(enc, 0, num_steps=3) == 0
        assert eng.submit(one, 1, 4, num_steps=3) == 1
        out = eng.run(key)
        outs[name] = torch.cat([out[0], out[1]])
        assert eng.stats["waves"] == 2 and eng.stats["padded"] == 2
    want = torch.cat([tsampler.sample_cfg(model, sched, w, prng.fold_in(
        key, i), num_steps=3) for i, w in enumerate(waves)])
    assert torch.equal(outs["grouped"], want[:14])
    rids = np.array([0] * 10 + [1] * 6)
    ridx = np.concatenate([np.arange(10), np.arange(4), [3, 3]])
    row_keys = prng.fold_in(prng.fold_in(key[None], rids), ridx)
    want = torch.cat([tsampler.sample_cfg_ragged(
        model, sched, w, row_keys[8 * i:8 * i + 8], np.full(8, 2.0,
                                                            np.float32),
        np.full(8, 3, np.int32)) for i, w in enumerate(waves)])
    assert torch.equal(outs["ragged"], want[:14])
    assert float((outs["compacted"] - outs["ragged"]).abs().max()) < TOL_DSYN
    # rows of one 2-D request differ: each sample has its own conditioning
    assert float((outs["ragged"][0] - outs["ragged"][1]).abs().max()) > 1e-3


def test_2d_requests_are_cached_by_their_rows_or_refused_when_miscounted(
        server):
    """A 2-D request's cache key hashes all its rows: the same rows again
    (in the same drain, or a later one) are served from the first one's
    rows bit for bit, the rows in another order are a request of their
    own, as in the reference's engine; a miscounted or misshapen request
    is refused."""
    jocfg, params, jsch, _, model, sched = server
    enc = np.random.default_rng(7).standard_normal((3, 512)) \
        .astype(np.float32)
    eng = SynthesisEngine(model, sched, image_size=16)
    with pytest.raises(ValueError, match="carries 3 rows"):
        eng.submit(enc, 0, 4)
    with pytest.raises(ValueError, match="count is required"):
        eng.submit(enc[0], 0)
    with pytest.raises(ValueError, match="shape"):
        eng.submit(enc[None], 0)
    ref = JEngine(params, jocfg.diffusion, jsch, image_size=16)
    drains = ((enc, enc.copy()), (enc.copy(), enc[::-1].copy()))
    outs = []
    for i, reqs in enumerate(drains):
        for e in (ref, eng):
            for r in reqs:
                e.submit(r, 1, num_steps=2)
        key = jax.random.PRNGKey(i)
        want, got = ref.run(key), eng.run(np.asarray(key))
        for rid, x in got.items():
            assert x.shape == (3, 16, 16, 3)
            assert float(np.max(np.abs(x.numpy() - want[rid]))) < TOL_DSYN
        assert eng.stats == {k: ref.stats[k] for k in STAT_KEYS}
        outs.append(got)
    assert torch.equal(outs[0][1], outs[0][0])
    assert torch.equal(outs[1][2], outs[0][0])
    assert float((outs[1][3] - outs[0][0]).abs().max()) > 1e-3
    assert eng.stats["generated"] == 6 and eng.stats["cache_hits"] == 6


def test_engine_opt_in_switches_on_never_off(server):
    *_, model, sched = server
    eng = SynthesisEngine(model, sched, image_size=16)
    assert eng.opt_in() is eng and not eng.ragged
    eng.opt_in(ragged=True)
    assert eng.ragged and eng.compaction is None
    eng.opt_in(compaction=2).opt_in(ragged=False)
    assert eng.ragged and eng.compaction == 2
    with pytest.raises(ValueError, match="compaction"):
        eng.opt_in(compaction=0)
