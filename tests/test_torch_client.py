"""The client side and the slice's entry points: procedural federated data,
the frozen encoder and per-category encodings against the JAX package,
and ``synthesize`` turning uploaded encodings into D_syn."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.oscar import DataConfig as JDataConfig
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.core import oscar as joscar
from repro.data.federated import make_federated_data as j_make_data
from repro.encoders.foundation import FrozenFM as JFrozenFM
from repro.encoders.foundation import category_encodings as j_cat_enc
from repro_torch import prng
from repro_torch.configs.oscar import DataConfig
from repro_torch.core import oscar as toscar
from repro_torch.data.federated import make_federated_data
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tsched
from repro_torch.encoders.foundation import FrozenFM, category_encodings
from test_torch_dit import perturbed_params, port_model

SMALL = dict(num_categories=4, num_domains=3, train_per_cat_dom=3,
             test_per_cat_dom=2)


def test_federated_data_is_bit_equal():
    for kw in (SMALL, dict(SMALL, pretrain_pool_per_cat_dom=2, seed=3)):
        ref, port = j_make_data(JDataConfig(**kw)), make_federated_data(
            DataConfig(**kw))
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(port, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


def test_frozen_fm_and_category_encodings_match_reference():
    data = make_federated_data(DataConfig(**SMALL))
    images, labels = data.client_images[1], data.client_labels[1]
    jfm, tfm = JFrozenFM(), FrozenFM()
    ref = np.asarray(jfm(jnp.asarray(images)))
    port = tfm(torch.from_numpy(images)).numpy()
    assert port.shape == (len(images), 512)
    assert np.max(np.abs(port - ref)) < 1e-5
    # a category absent from the shard stays zero and not present
    keep = labels != 2
    rm, rp = j_cat_enc(jfm, jnp.asarray(images[keep]),
                       jnp.asarray(labels[keep]), 4)
    tm, tp = category_encodings(tfm, torch.from_numpy(images[keep]),
                                labels[keep], 4)
    assert np.array_equal(tp.numpy(), np.asarray(rp))
    assert not tp[2] and torch.count_nonzero(tm[2]) == 0
    assert np.max(np.abs(tm.numpy() - np.asarray(rm))) < 1e-5


def test_client_encodings_match_reference():
    data = make_federated_data(DataConfig(**SMALL))
    ref_enc, ref_present = joscar.client_encodings(JFrozenFM(), data)
    enc, present = toscar.client_encodings(FrozenFM(), data, device="cpu")
    assert enc.shape == (3, 4, 512) and enc.dtype == np.float32
    assert np.array_equal(present, ref_present)
    assert np.max(np.abs(enc - ref_enc)) < 1e-5


def _server():
    dc = dict(d_model=32, num_layers=1, num_heads=2)
    model = port_model(perturbed_params(JDiffusionConfig(**dc), 16), dc, 16)
    return model, tsched.make_schedule(device="cpu")


def test_synthesize_waves_equal_one_sample_cfg_call():
    """Rows are the present (client, category) encodings repeated
    k_samples times in (client, category) order; one group's rows fill
    near-uniform waves, and wave i is one ``sample_cfg`` call on the
    wave key ``fold_in(key, i)``."""
    model, sched = _server()
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 3, 512)).astype(np.float32)
    present = np.array([[True, False, True], [True, True, False]])
    key = prng.PRNGKey(4)
    images, labels = toscar.synthesize(
        key, model, sched, enc, present, 2, image_size=16, num_steps=2,
        wave_size=8)
    assert images.shape == (8, 16, 16, 3)
    assert labels.tolist() == [0, 0, 2, 2, 0, 0, 1, 1]
    rows = torch.from_numpy(np.repeat(enc[present], 2, axis=0))
    whole = tsampler.sample_cfg(model, sched, rows, prng.fold_in(key, 0),
                                num_steps=2)
    assert torch.equal(images, whole)
    # 24 rows in waves of at most 8: three waves of 8, each on its own key
    waves, _ = toscar.synthesize(
        key, model, sched, enc, present, 6, image_size=16, num_steps=2,
        wave_size=8)
    rows = torch.from_numpy(np.repeat(enc[present], 6, axis=0))
    assert waves.shape == (24, 16, 16, 3)
    for i in range(3):
        wave = tsampler.sample_cfg(model, sched, rows[8 * i:8 * i + 8],
                                   prng.fold_in(key, i), num_steps=2)
        assert torch.equal(waves[8 * i:8 * i + 8], wave)


def test_synthesize_with_nothing_present_is_empty():
    model, sched = _server()
    images, labels = toscar.synthesize(
        prng.PRNGKey(0), model, sched, np.zeros((2, 3, 512), np.float32),
        np.zeros((2, 3), bool), 4, image_size=16)
    assert images.shape == (0, 16, 16, 3) and labels.shape == (0,)
