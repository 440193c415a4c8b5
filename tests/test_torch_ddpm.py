"""DM pretraining, the port against the JAX package from the same keys:
``diffusion_loss`` (value and gradients), the group means and batches
``pretrain_dm`` trains on, and three ``pretrain_dm`` steps.

adaLN-zero makes every DiT output 0 at init, so the loss test perturbs
the weights 0.05·normal (``test_torch_dit.perturbed_params``).  The
gradients are fp32 sums in another order: 9.3e-9 measured against
gradients of up to 0.023, the loss 7.2e-7 of 1.08.

The parameters after three ``pretrain_dm`` steps from the init, on every
element: adaLN-zero gives only ``patch_out`` a gradient at step 1, the
modulations, positions and patch embedding at step 2 and every element at
step 3, small but real ones (down to ~1e-13, products of small gates),
and Adam steps each by up to ``lr`` = 3e-4 in its gradient's direction.
Measured 1.2e-7 (one ulp of a parameter near 1), so the gate is 1e-6.
Planted faults in the port's step, each failing it: b2 0.96 moves an
element by 7.1e-6, b1 0.89 by 1.2e-5, eps 1e-7 by 2.4e-4, updates that
reach only ``patch_out`` by 4.8e-4; a flipped update or a missing bias
correction moves the losses by 2.6e-3 or more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import ddpm as jddpm
from repro.diffusion import schedule as jsched
from repro_torch import prng
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.convert import dit_state_from_jax
from repro_torch.diffusion import ddpm as tddpm
from repro_torch.diffusion import schedule as tsched
from test_torch_dit import perturbed_params, port_model
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DC = dict(d_model=32, num_layers=2, num_heads=2, train_timesteps=16,
          cond_drop_prob=0.3, group_cond_prob=0.4, batch_size=8)
TOL_LOSS, TOL_GRAD, TOL_PARAM = 1e-5, 1e-6, 1e-6


def _batch(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
            rng.normal(size=(n, 512)).astype(np.float32),
            rng.normal(size=(n, 512)).astype(np.float32))


@pytest.mark.parametrize("group", [False, True], ids=["y", "y_group"])
def test_diffusion_loss_and_gradients_match_reference(group):
    jdc = JDiffusionConfig(**DC)
    params = perturbed_params(jdc, 16)
    model = port_model(params, DC, 16)
    model.plain = True
    x, y, yg = _batch()
    key = jax.random.PRNGKey(4)
    # the draws are not vacuous: some rows take the group mean, some Ø
    kt, kn, kd, kg = prng.split(np.asarray(key), 4)
    assert 0 < int(prng.bernoulli(kd, 0.3, (12,)).sum()) < 12
    assert 0 < int(prng.bernoulli(kg, 0.4, (12,)).sum()) < 12
    ref, ref_g = jax.jit(jax.value_and_grad(jddpm.diffusion_loss),
                         static_argnums=1)(
        params, jdc, jsched.make_schedule(16), jnp.asarray(x),
        jnp.asarray(y), key, jnp.asarray(yg) if group else None)
    loss = tddpm.diffusion_loss(model, DiffusionConfig(**DC),
                                tsched.make_schedule(16, device="cpu"), x, y,
                                np.asarray(key), yg if group else None)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref)) < TOL_LOSS
    want = dit_state_from_jax(jax.tree.map(np.asarray, ref_g))
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    assert max(float(want[k].abs().max()) for k in names) > 1e-2
    for k, g in zip(names, grads):
        assert float((g - want[k]).abs().max()) < TOL_GRAD, k


def test_pretraining_batches_and_group_means_are_the_references(monkeypatch):
    """Every step's batch and its group-mean conditioning, as the
    reference's ``pretrain_dm`` hands them to its step (``ddpm.py:70-81``:
    ``np.add.at``, counts clipped at 1, the norm plus 1e-6)."""
    x, y, _ = _batch(n=20, seed=1)
    groups = np.random.default_rng(2).integers(0, 6, 20)
    groups[groups == 4] = 5                       # an empty group
    seen = []

    def fake_step(dc, sched):
        def step(params, opt, x0, yb, y_group, key):
            seen.append((np.asarray(x0), np.asarray(y_group)))
            return params, opt, jnp.zeros(())
        return step

    monkeypatch.setattr(jddpm, "make_dm_train_step", fake_step)
    jddpm.pretrain_dm(jax.random.PRNGKey(5), JDiffusionConfig(**DC), x, y,
                      image_size=16, channels=3, steps=4, groups=groups)
    gm = tddpm.group_means(y, groups)
    kloop = prng.split(np.asarray(jax.random.PRNGKey(5)))[1]
    for x0, y_group in seen:
        kloop, kb, _ = prng.split(kloop, 3)
        idx = prng.randint(kb, (8,), 0, 20).numpy()
        assert np.array_equal(x0, x[idx])
        assert np.array_equal(y_group, gm[idx])
    assert len(seen) == 4


def test_pretrain_dm_matches_reference_after_three_steps():
    x, y, _ = _batch(n=20, seed=3)
    groups = np.random.default_rng(4).integers(0, 4, 20)
    key = jax.random.PRNGKey(3)
    jdc = JDiffusionConfig(**DC)
    ref, _, ref_losses = jddpm.pretrain_dm(key, jdc, x, y, image_size=16,
                                           channels=3, steps=3,
                                           groups=groups)
    model, sched, losses = tddpm.pretrain_dm(
        np.asarray(key), DiffusionConfig(**DC), x, y, image_size=16,
        channels=3, steps=3, groups=groups, device="cpu")
    assert model.plain is False and sched.T == 16
    assert [i for i, _ in losses] == [0, 1, 2]
    assert max(abs(a - b) for (_, a), (_, b) in zip(losses, ref_losses)) \
        < TOL_LOSS
    want = dit_state_from_jax(jax.tree.map(np.asarray, ref))
    got = model.state_dict()
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"3 pretraining steps: max |port - reference| {err:.3g} over "
          f"{sum(v.numel() for v in want.values())} parameters "
          f"(tol {TOL_PARAM:g})")
    assert err <= TOL_PARAM
    # and the weights moved: patch_out by ~lr a step from zero
    assert float(got["patch_out.weight"].abs().max()) > jdc.lr


def test_pretrain_dm_draws_do_not_depend_on_the_chunk(monkeypatch):
    x, y, _ = _batch(n=10, seed=5)
    dc = DiffusionConfig(**DC)
    runs = []
    for chunk in (100, 2):
        monkeypatch.setattr(tddpm, "CHUNK", chunk)
        model, _, losses = tddpm.pretrain_dm(
            prng.PRNGKey(6), dc, x, y, image_size=16, channels=3, steps=3,
            device="cpu")
        runs.append((model.state_dict(), losses))
    (a, la), (b, lb) = runs
    assert la == lb
    assert all(torch.equal(a[k], b[k]) for k in a)
