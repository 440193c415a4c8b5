"""Classifier training and the OSCAR pipeline end to end, the port against
the JAX package: ``prng.randint``, the optimizers, ``xent``,
``train_classifier``, ``fit_global``, evaluation, ``run_oscar`` and the
communication accounting, on the same seeded numpy inputs.

Both packages draw a classifier's initial weights from its key, the port
within a few ulps of the reference (``test_torch_init.py``).  The parity
tests of the training arithmetic hand both sides the same seeded weights
all the same: each package's key-taking init is replaced by one that
builds ``random_classifier``'s values from the key's 64 bits, so those
tests hold the arithmetic apart from the init.

The gradient of a ReLU network jumps where a ReLU input crosses 0, and
the packages round a ReLU input differently by up to ~2e-7, so one
sample with an input that close to 0 moves a ResNet-18's gradient by
~0.09 (data seed 3, 16 samples).  The ResNet-18 cases therefore use data
(seed 1) on which every ReLU input the port computes lies at least 1e-6
from 0, and assert it; the pipeline test trains the ViT, whose gelu,
softmax and LayerNorm are smooth, since its inputs are D_syn images that
already differ between the packages by up to the 5e-4 sampler gate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.oscar import DataConfig as JDataConfig
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.configs.oscar import OscarConfig as JOscarConfig
from repro.core import classifier_train as jct
from repro.core import comm as jcomm
from repro.core import oscar as joscar
from repro.diffusion import schedule as jsched
from repro.encoders.foundation import FrozenFM as JFrozenFM
from repro.optim import optimizers as jopt
from repro_torch import prng
from repro_torch.configs.oscar import DataConfig, DiffusionConfig, OscarConfig
from repro_torch.convert import classifier_state_from_jax
from repro_torch.core import classifier_train as tct
from repro_torch.core import comm as tcomm
from repro_torch.core import dm_baselines as tdm
from repro_torch.core import fl as tfl
from repro_torch.core import oscar as toscar
from repro_torch.data.federated import make_federated_data
from repro_torch.diffusion import schedule as tsched
from repro_torch.encoders.foundation import FrozenFM
from repro_torch.models import classifiers as tclf
from repro_torch.optim import optimizers as topt
from repro_torch.utils import recorded_relu
from test_torch_classifiers import random_classifier
from test_torch_dit import perturbed_params, port_model
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# three SGD steps of a seeded classifier: parameters move by ~0.2-0.6 and
# differ by 1.3e-7 (ResNet-18) and 6.6e-7 (ViT), fp32 sums in another
# order through three forward and backward passes.  The loss with its l2
# term (fp32 sums of ~0.1-0.5M squares) is gated relative to its size:
# 5e-7 (ResNet-18, 5.6) and 8.8e-7 (ViT, 26.1) measured
TOL_PARAMS = 1e-5
TOL_LOSS = 1e-5


@functools.lru_cache(maxsize=None)
def _seeded(name, seed, num_classes):
    params, model = random_classifier(name, seed=seed,
                                      num_classes=num_classes)
    return params, model.state_dict()


def _seed_of_key(key) -> int:
    k = np.asarray(key, np.uint32).reshape(2)
    return (int(k[0]) << 32 | int(k[1])) % 2 ** 32


def inject_init(monkeypatch, *ref_modules):
    """Both packages' key-taking inits (``init_classifier`` as the
    reference's ``ref_modules`` and the port's trainers call it) give
    ``random_classifier``'s weights, seeded by the key."""
    def ref_init(key, name, num_classes, in_ch=3):
        return jax.tree.map(jnp.asarray,
                            _seeded(name, _seed_of_key(key), num_classes)[0])

    def port_init(key, name, num_classes, in_ch=3, *, device=None):
        _, state = _seeded(name, _seed_of_key(key), num_classes)
        model = tclf.classifier_module(name, num_classes, device="cpu")
        model.load_state_dict(state)
        return model.to(device)

    for mod in ref_modules:
        monkeypatch.setattr(mod, "init_classifier", ref_init)
    for mod in (tct, tfl, toscar, tdm):
        monkeypatch.setattr(mod, "init_classifier", port_init)


def max_param_err(ref_tree, model, name) -> float:
    want = classifier_state_from_jax(jax.tree.map(np.asarray, ref_tree),
                                     name)
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    return max(float((want[k] - v.cpu()).abs().max()) for k, v in got.items())


@pytest.fixture
def relu_margin():
    """The smallest |ReLU input| the port computes while the test runs."""
    margins = [np.inf]
    with recorded_relu(lambda v: margins.append(float(v.abs().min()))):
        yield lambda: min(margins)


def _data(seed=1, n=24, size=16, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


# -- prng.randint -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (8,), (64,)])
@pytest.mark.parametrize("span", [1, 7, 2 ** 16, 2 ** 16 + 1, 2 ** 31 - 1])
def test_randint_is_bit_equal_to_jax(shape, span):
    for seed, minval in ((0, 0), (5, -3), (17, 2)):
        key = jax.random.PRNGKey(seed)
        maxval = min(minval + span, 2 ** 31 - 1)
        ref = np.asarray(jax.random.randint(key, shape, minval, maxval))
        got = prng.randint(np.asarray(key), shape, minval, maxval)
        assert got.dtype == torch.int32 and ref.dtype == np.int32
        assert np.array_equal(got.numpy(), ref)


def test_randint_batches_keys_and_degenerate_spans():
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    ref = np.stack([np.asarray(jax.random.randint(k, (8,), 0, 100))
                    for k in keys])
    assert np.array_equal(
        prng.randint(np.asarray(keys), (8,), 0, 100).numpy(), ref)
    key = jax.random.PRNGKey(3)
    for lo, hi in ((5, 3), (4, 4)):             # span ≤ 0 gives minval
        assert np.array_equal(
            prng.randint(np.asarray(key), (4,), lo, hi).numpy(),
            np.asarray(jax.random.randint(key, (4,), lo, hi)))


def test_training_batches_are_the_references():
    """``batch_indices`` folds in each step, then draws: one call for all
    steps, the reference's per-step ``randint(fold_in(key, i))``."""
    key = jax.random.PRNGKey(11)
    idx = tct.batch_indices(np.asarray(key), 6, 16, 24, "cpu")
    assert idx.shape == (6, 16) and idx.dtype == torch.int64
    for i in range(6):
        ref = jax.random.randint(jax.random.fold_in(key, i), (16,), 0, 24)
        assert np.array_equal(idx[i].numpy(), np.asarray(ref))
    keys = jax.random.split(key, 3)
    idx = tct.batch_indices(np.asarray(keys), 2, 4, 24, "cpu")
    assert idx.shape == (3, 2, 4)
    ref = jax.random.randint(jax.random.fold_in(keys[2], 1), (4,), 0, 24)
    assert np.array_equal(idx[2, 1].numpy(), np.asarray(ref))


# -- optimizers -----------------------------------------------------------------

def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(3)]


def _close(ref_tree, port_tree, tol=1e-6):
    for k, v in port_tree.items():
        assert np.max(np.abs(v.numpy() - np.asarray(ref_tree[k]))) < tol, k


@pytest.mark.parametrize("opt", ["sgdm", "adamw"])
def test_optimizer_steps_match_reference(opt):
    params, g1, g2 = _trees()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    if opt == "sgdm":
        kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
        js, ts = jopt.init_sgdm(jp), topt.init_sgdm(tp)
        jstep, tstep = jopt.sgdm, topt.sgdm
    else:
        kw = dict(lr=jopt.cosine_schedule(1e-2, 2, 10), weight_decay=0.1)
        js, ts = jopt.init_adamw(jp), topt.init_adamw(tp)
        jstep, tstep = jopt.adamw, topt.adamw
        kw_t = dict(kw, lr=topt.cosine_schedule(1e-2, 2, 10))
    for g in (g1, g2, g1):
        ju, js = jstep({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                       **kw)
        tu, ts = tstep({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                       tp, **(kw if opt == "sgdm" else kw_t))
        _close(ju, tu)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _close(jp, tp)
    assert ts.step == int(js.step) == 3
    # lists are trees too
    lu, _ = topt.sgdm(list(tu.values()), topt.init_sgdm(list(tp.values())),
                      list(tp.values()), lr=0.1)
    assert isinstance(lu, list) and len(lu) == 3


def test_clip_by_global_norm_and_cosine_schedule_match_reference():
    _, g, _ = _trees(1)
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tc, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        assert abs(float(tn) - float(jn)) < 1e-6 * float(jn)
        _close(jc, tc)
    jl, tl = jopt.cosine_schedule(0.1, 5, 40), topt.cosine_schedule(0.1, 5,
                                                                     40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        assert abs(float(tl(step)) - float(jl(jnp.int32(step)))) < 1e-6


# -- xent, training, evaluation -------------------------------------------------

def test_recorded_relu_sees_every_input_and_restores_relu():
    relu = torch.nn.functional.relu
    model = tclf.init_classifier(prng.PRNGKey(0), "resnet18", 5,
                                 device="cpu")
    x = torch.from_numpy(_data(n=2)[0])
    seen = []
    with recorded_relu(seen.append):
        out = model(x)
    assert torch.nn.functional.relu is relu
    assert len(seen) == 13 and seen[0].shape == (2, 16, 16, 16)
    assert not any(v.requires_grad for v in seen)
    assert torch.equal(out, model(x))
    with pytest.raises(ValueError), recorded_relu(seen.append):
        raise ValueError
    assert torch.nn.functional.relu is relu


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_xent_and_its_gradients_match_reference(l2, relu_margin):
    params, model = random_classifier("resnet18", num_classes=5)
    x, y = _data()
    ref_loss, ref_grad = jax.value_and_grad(jct.xent)(
        params, "resnet18", jnp.asarray(x), jnp.asarray(y), l2=l2)
    loss = tct.xent(model, "resnet18", x, y, l2=l2)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert relu_margin() > 1e-6, "a ReLU input sits at a kink"
    assert abs(loss.item() - float(ref_loss)) < 1e-5
    want = classifier_state_from_jax(jax.tree.map(np.asarray, ref_grad),
                                     "resnet18")
    for (k, _), g in zip(model.named_parameters(), grads):
        assert float((g - want[k]).abs().max()) < 1e-5, k


@pytest.mark.parametrize("name", ["resnet18", "vit_b16"])
def test_train_classifier_matches_reference_after_three_steps(name,
                                                              relu_margin):
    params, model = random_classifier(name, num_classes=5)
    x, y = _data()
    key = jax.random.PRNGKey(7)
    ref = jct.train_classifier(params, name, jnp.asarray(x), jnp.asarray(y),
                               key, steps=3, batch=16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = tct.train_classifier(model, name, x, y, np.asarray(key), steps=3,
                               batch=16)
    # the module handed in is left as it was
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    assert max(float((before[k] - v).abs().max())
               for k, v in got.state_dict().items()) > 0.1
    assert max_param_err(ref, got, name) < TOL_PARAMS
    ref_loss = jct.xent(ref, name, jnp.asarray(x), jnp.asarray(y), l2=1e-3)
    with torch.no_grad():
        loss = tct.xent(got, name, x, y, l2=1e-3)
    assert relu_margin() > 1e-6, "a ReLU input sits at a kink"
    assert abs(float(loss) - float(ref_loss)) < TOL_LOSS * float(ref_loss)


def test_fit_global_matches_reference_with_the_init_injected(monkeypatch,
                                                              relu_margin):
    inject_init(monkeypatch, jct)
    x, y = _data()
    key = jax.random.PRNGKey(21)
    ref = jct.fit_global(key, "resnet18", 5, x, y, steps=3, batch=16)
    got = tct.fit_global(np.asarray(key), "resnet18", 5, x, y, steps=3,
                         batch=16, device="cpu")
    assert relu_margin() > 1e-6, "a ReLU input sits at a kink"
    assert max_param_err(ref, got, "resnet18") < TOL_PARAMS


def test_init_from_key_is_fixed_by_the_key():
    a, b, c = (tclf.init_classifier(prng.PRNGKey(s), "resnet18", 4,
                                   device="cpu")
               for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def test_evaluate_per_domain_gives_the_references_accuracies():
    data = make_federated_data(DataConfig(num_categories=5, num_domains=3,
                                          train_per_cat_dom=1,
                                          test_per_cat_dom=20))
    params, model = random_classifier("resnet18", seed=4, num_classes=5)
    ref = jct.evaluate_per_domain(params, "resnet18", data)
    got = tct.evaluate_per_domain(model, "resnet18", data)
    assert list(got) == ["avg", "client1", "client2", "client3"]
    assert got == ref
    assert 0 < got["avg"] < 1
    # batches of 7 and a short last batch give the same count
    assert tct.evaluate(model, "resnet18", data.test_images,
                        data.test_labels, batch=7) == ref["avg"]
    assert np.array_equal(
        tct.predict(model, "resnet18", data.test_images[:9]).numpy(),
        np.asarray(jct.predict(params, "resnet18",
                               jnp.asarray(data.test_images[:9]))))


# -- run_oscar ------------------------------------------------------------------

DC = dict(d_model=32, num_layers=1, num_heads=2, train_timesteps=16,
          sample_timesteps=4)
DATA = dict(num_categories=3, num_domains=2, train_per_cat_dom=3,
            test_per_cat_dom=4)
OSCAR = dict(samples_per_category=3, classifier_steps=2, classifier_batch=8)
# D_syn: the sampler gate at smoke depth (guidance 2.0, T = 16; 3.2e-4
# measured).  The ViT trained two steps on D_syn takes those differences
# into its weights through lr 0.05 gradients: 6.3e-6 measured
TOL_DSYN = 5e-4
TOL_OSCAR_PARAMS = 1e-4


@pytest.fixture(scope="module")
def oscar_server():
    jdc = JDiffusionConfig(**DC)
    params = perturbed_params(jdc, 16)
    jocfg = JOscarConfig(data=JDataConfig(**DATA), diffusion=jdc, **OSCAR)
    tocfg = OscarConfig(data=DataConfig(**DATA),
                        diffusion=DiffusionConfig(**DC), **OSCAR)
    return (jocfg, params, jsched.make_schedule(16), tocfg,
            port_model(params, DC, 16), tsched.make_schedule(16, device="cpu"),
            make_federated_data(DataConfig(**DATA)))


@pytest.mark.parametrize("degenerate,injected", [
    (False, True), (True, True), (False, False)],
    ids=["dsyn", "no-dsyn", "from-key"])
def test_run_oscar_matches_reference(oscar_server, monkeypatch, degenerate,
                                     injected):
    """``run_oscar`` from one key, the port against the reference.  The
    injected cases hand both packages ``random_classifier``'s weights for
    the global ViT; "from-key" injects nothing, so each package draws the
    ViT's initial weights from ``kclf`` itself (``test_torch_init.py``
    holds those draws within a few ulps)."""
    jocfg, params, jsch, tocfg, model, sched, data = oscar_server
    if injected:
        inject_init(monkeypatch, jct, joscar)
    if degenerate:
        # nothing present anywhere: no D_syn, the broadcast model is the init
        def nothing(fm, data, **kw):
            return np.zeros((2, 3, 512), np.float32), np.zeros((2, 3), bool)
        monkeypatch.setattr(joscar, "client_encodings", nothing)
        monkeypatch.setattr(toscar, "client_encodings", nothing)
    key = jax.random.PRNGKey(31)
    ref = joscar.run_oscar(key, jocfg, data, params, jsch, JFrozenFM(),
                           classifier="vit_b16")
    got = toscar.run_oscar(np.asarray(key), tocfg, data, model, sched,
                           FrozenFM(), classifier="vit_b16")
    assert got.upload_per_client == ref.upload_per_client == 3 * 512
    assert np.max(np.abs(got.encodings - ref.encodings)) < 1e-5
    assert np.array_equal(got.syn_labels.numpy(), ref.syn_labels)
    assert got.syn_images.shape == ref.syn_images.shape == (
        (0 if degenerate else 18), 16, 16, 3)
    if not degenerate:
        assert float(np.abs(ref.syn_images).max()) > 1e-2
        assert float(np.max(np.abs(got.syn_images.numpy()
                                   - ref.syn_images))) < TOL_DSYN
    assert max_param_err(ref.global_params, got.global_params,
                         "vit_b16") < (TOL_PARAMS if degenerate
                                       else TOL_OSCAR_PARAMS)
    if degenerate:
        init = toscar.init_classifier(prng.split(np.asarray(key), 3)[2],
                                      "vit_b16", 3, device="cpu")
        assert all(torch.equal(v, got.global_params.state_dict()[k])
                   for k, v in init.state_dict().items())
    assert got.metrics == ref.metrics
    assert sorted(got.metrics) == ["avg", "client1", "client2"]


# -- comm -----------------------------------------------------------------------

@pytest.mark.parametrize("method", ["local", "fedavg", "fedprox", "feddyn",
                                    "fedcado", "feddisc", "oscar"])
def test_upload_accounting_equals_reference(method):
    kw = dict(num_categories=7, enc_dim=512, clf_params=12345, rounds=10,
              n_prototypes=4)
    assert tcomm.upload_params(method, **kw) == jcomm.upload_params(method,
                                                                    **kw)


def test_comm_tables_equal_reference():
    with pytest.raises(ValueError):
        tcomm.upload_params("fedsgd", num_categories=2)
    assert tcomm.paper_scale_table4() == jcomm.paper_scale_table4()
    table = tcomm.paper_scale_table4()
    assert tcomm.reduction_vs_sota(table["OSCAR"], table) == \
        jcomm.reduction_vs_sota(table["OSCAR"], table)
