"""The port's classifier zoo against the JAX package's.

Parameters have the structure of the reference ``init_classifier``'s tree
and seeded numpy values (weights at the reference's 1/√fan_in scale, norm
scales 1 + 0.05·normal and biases 0.05·normal, so that GroupNorm's and
LayerNorm's parameters are tested too); they cross over through
``repro_torch.convert.classifier_state_from_jax``.  Both packages run the
same function of the same numbers.  Logits and the input
gradient of Σ log p(y|x), normalised per sample as classifier guidance
normalises it, are gated at 1e-4: fp32 convolutions and matmuls summed
in another order, over values of order 1 to 10.

The gradient of a ReLU network jumps where a ReLU input crosses 0, and
the two packages round a ReLU input differently by up to ~2e-7, so a
point with an input that close to 0 has two right gradients (input seed
16 put a DenseNet transition input at −8.9e-8 in the reference and
+1.3e-7 here: the normalised gradients then differ by 3.8e-3).  The
inputs are therefore seeded where every ReLU input of the port lies at
least 1e-6 from 0, and each test asserts that before it compares.  The
ResNets, whose
global mean pool takes any size, also run at 12 px, where the second
stride-2 stage sees an odd input (6 → 3) and the "SAME" padding splits
(1, 1) instead of (0, 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import classifiers as jclf
from repro_torch import prng
from repro_torch.convert import classifier_state_from_jax
from repro_torch.diffusion import guidance as tguid
from repro_torch.models import classifiers as tclf
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
CASES = [(name, 16) for name in jclf.CLASSIFIERS] + [
    (name, 12) for name in ("resnet18", "resnet50", "resnet101")]


def random_classifier(name, seed=0, num_classes=10):
    """(reference tree, port module) holding the same seeded values."""
    shapes = jax.eval_shape(lambda: jclf.init_classifier(
        jax.random.PRNGKey(0), name, num_classes))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        last = path[-1].key
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if last == "w":
            return a / np.sqrt(np.prod(sd.shape[:-1]))
        if last == "scale":
            return 1 + 0.05 * a
        if last in ("b", "bias"):
            return 0.05 * a
        return 0.02 * a                               # pos, cls
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    model = tclf.classifier_module(name, num_classes, device="cpu")
    model.load_state_dict(classifier_state_from_jax(params, name))
    return params, model


def jax_logprob(params, name):
    """The reference's log p(y|x) closure (``core/dm_baselines.py``)."""
    def logprob(x, labels):
        logp = jax.nn.log_softmax(jclf.classifier_apply(params, name, x), -1)
        return jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    return logprob


def _unit(g):
    g = np.asarray(g)
    return g / np.sqrt(np.sum(g ** 2, axis=(1, 2, 3), keepdims=True))


@pytest.mark.parametrize("name,size", CASES,
                         ids=[f"{n}-{s}px" for n, s in CASES])
def test_classifier_logits_and_guidance_gradient_match_reference(
        name, size, monkeypatch):
    params, model = random_classifier(name)
    relu, margin = torch.nn.functional.relu, []

    def recorded_relu(v, *args, **kwargs):
        margin.append(float(v.detach().abs().min()))
        return relu(v, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "relu", recorded_relu)
    rng = np.random.default_rng(400 + size)
    x = rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    labels = np.array([1, 4, 7], np.int32)

    @jax.jit       # parameters as arguments: constants would slow the compile
    def ref(params, x):
        fn = jax_logprob(params, name)
        logits = jclf.classifier_apply(params, name, x)
        return logits, jax.grad(lambda z: jnp.sum(fn(z, labels)))(x)

    ref_logits, ref_grad = ref(params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        logits = tclf.classifier_apply(model, xt)
    grad = tguid._logprob_grad(tclf.classifier_logprob(model), xt,
                               torch.from_numpy(labels))
    assert min(margin, default=1.0) > 1e-6, "a ReLU input sits at a kink"
    assert logits.shape == (3, 10)
    assert float(np.abs(ref_logits).max()) > 0.1
    assert float(np.max(np.abs(logits.numpy() - ref_logits))) < TOL
    assert float(np.max(np.abs(_unit(grad) - _unit(ref_grad)))) < TOL


@pytest.mark.parametrize("name", jclf.CLASSIFIERS)
def test_param_count_and_state_match_reference(name):
    params, _ = random_classifier(name, num_classes=7)
    model = tclf.init_classifier(prng.PRNGKey(0), name, 7, device="cpu")
    assert tclf.classifier_param_count(model) == \
        jclf.classifier_param_count(params)
    state = classifier_state_from_jax(params, name)
    assert sorted(state) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert state[k].shape == v.shape, k


def test_same_padding_splits_like_xla():
    """XLA's "SAME": the smaller half of the padding goes before."""
    assert tclf._same_pads(16, 3, 2) == (0, 1)
    assert tclf._same_pads(3, 3, 2) == (1, 1)
    assert tclf._same_pads(16, 3, 1) == (1, 1)
    assert tclf._same_pads(16, 1, 2) == (0, 0)
    x = torch.randn(1, 1, 8, 8)
    conv = tclf._Conv(3, 1, 1, "cpu")
    torch.nn.init.normal_(conv.weight)
    out = conv(x, 2)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (0, 1, 0, 1)), conv.weight, stride=2)
    assert torch.equal(out, want)


def test_init_is_seeded_and_logprob_freezes_weights():
    a, b, c = (tclf.init_classifier(prng.PRNGKey(s), "resnet18", 10,
                                    device="cpu")
               for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    fn = tclf.classifier_logprob(a)
    assert not any(p.requires_grad for p in a.parameters())
    x = torch.rand(2, 16, 16, 3) * 2 - 1
    grad = tguid._logprob_grad(fn, x, torch.tensor([0, 3]))
    assert grad.shape == x.shape and float(grad.abs().max()) > 0
    assert all(p.grad is None for p in a.parameters())
    with pytest.raises(ValueError):
        tclf.init_classifier(prng.PRNGKey(0), "resnet9", 10, device="cpu")
    with pytest.raises(ValueError):
        classifier_state_from_jax({}, "resnet9")


def test_init_classifier_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclf.init_classifier(prng.PRNGKey(0), "resnet18", 10)


def test_guidance_gradient_of_a_row_does_not_depend_on_the_rows_beside_it():
    """``_logprob_grad`` calls the classifier on fixed-size chunks, so a
    row's gradient is the same bits whether it shares the call with 4 rows
    or with 129, and on either side of a chunk boundary."""
    model = tclf.init_classifier(prng.PRNGKey(5), "resnet18", 10,
                                 device="cpu")
    fn = tclf.classifier_logprob(model)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((130, 16, 16, 3), generator=gen) * 2 - 1
    labels = torch.arange(130) % 10
    full = tguid._logprob_grad(fn, x, labels)
    assert full.shape == x.shape
    for rows in (slice(0, 5), slice(125, 130), slice(60, 70)):
        assert torch.equal(tguid._logprob_grad(fn, x[rows], labels[rows]),
                           full[rows])
