"""The port's training launcher (``launch/train.py``), input stand-ins
(``configs/shapes.py::input_specs``), accounting (``launch/hlo_analysis.py``)
and dry run (``launch/dryrun.py``), and ``Parallel``'s layout fields in the
LM, against the JAX package's on the CPU.

Oracles:

* the launcher: the reference's launcher cannot run here (its embedding
  gather on placed inputs fails jax's sharding-in-types check), so each
  step is held against the reference's jitted ``make_train_step`` with the
  same 1×1 mesh ``Parallel`` on unplaced inputs, drawn from the same keys
  (``fold_in(PRNGKey(0), i)``): from the launcher's own state, loss and
  gradient norm at 1e-5 relative; along the reference's own trajectory,
  the losses at 1e-5 and the parameters after two steps within 1e-5 of
  each leaf's largest element plus AdamW's gate
  (``optimizers.adamw_update_bound`` from the reference's moments, as
  ``test_torch_lm_train.py``);
* ``input_specs`` and ``denoiser_cost``: the reference's, exactly;
* the dry run: the reference's integration checks (``ok`` with t_compute
  below 1 ms for xlstm-125m decode, ``skip`` for an encoder's decode) and
  its record keys;
* the layout fields: the LM without them, bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import shapes as jshapes
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.launch import hlo_analysis as jhlo
from repro.models.moe import Parallel as JParallel
from repro.models.transformer import init_lm as jinit_lm
from repro.optim.optimizers import AdamWState as JAdamWState
from repro.train.steps import TrainState as JTrainState
from repro.train.steps import (init_train_state as jinit_train_state,
                               make_train_step as jmake_train_step)
from repro.utils import tree_map_with_path
from repro_torch import prng
from repro_torch.configs import INPUT_SHAPES, DiffusionConfig, get_config
from repro_torch.configs import input_specs, shapes as tshapes
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import train as launch_train
from repro_torch.convert import lm_state_items
from repro_torch.launch.mesh import NamedSharding, make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import init_lm
from repro_torch.optim.optimizers import AdamWState, adamw_update_bound
from repro_torch.train.steps import init_train_state
from test_torch_lm_train import as_state
from test_torch_sharding import PAIRS
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL_REL = 1e-5
LR = 3e-4
STEPS, B, S = 2, 2, 16
# the reference dry run's record (launch/dryrun.py::build)
RECORD_KEYS = {"arch", "shape", "multi_pod", "status", "note", "mesh",
               "n_devices", "batch_sharded", "overrides", "t_lower_s",
               "t_compile_s", "params_total", "params_active",
               "flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "collectives", "roofline",
               "bottleneck", "model_flops", "useful_flops_ratio", "memory"}


def ref_tree(state: dict, jcfg, tcfg):
    """The reference's ``init_lm``-shaped tree holding a port state dict
    (weights, or AdamW moments keyed alike): each leaf where
    ``convert.lm_state_items`` pairs it, transposed back, groups stacked."""
    sds = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), jcfg))
    bufs = {}
    for name, load in lm_state_items(tree_map_with_path(lambda p, _: p, sds),
                                     tcfg):
        a = state[name].detach().numpy()
        a = a.T if load.transpose else a
        if load.group is None:
            bufs[load.leaf] = a
        else:
            bufs.setdefault(load.leaf, {})[load.group] = a
    return tree_map_with_path(lambda p, _: jnp.asarray(
        np.stack([bufs[p][g] for g in range(len(bufs[p]))])
        if isinstance(bufs[p], dict) else bufs[p]), sds)


def _close(got: float, want: float, what) -> None:
    assert abs(got - want) <= TOL_REL * abs(want), (what, got, want)


@pytest.mark.parametrize("arch", ["xlstm-125m", "qwen2-7b"])
def test_launcher_steps_match_the_reference_train_step(arch, capsys):
    """``main()`` on the CPU, 2 steps of 2 × 16 on a 1×1 mesh, against the
    reference's jitted step with a 1×1 mesh ``Parallel`` on the same
    batches:

    * each step from the launcher's own state (its initial draw, then its
      weights and moments after step 0, from a 1-step run): loss and
      gradient norm at 1e-5;
    * along the reference's own trajectory from its own initial draw: the
      losses at 1e-5 and the parameters after both steps within AdamW's
      gate.  The gradient norm after step 0 is not held there: AdamW moves
      a weight whose gradient is rounding noise by ~lr in the noise's
      direction (the gate's point), which moves xlstm-smoke's next
      gradient norm by 3e-5 from the same initial weights."""
    run = lambda n: launch_train.main([
        "--arch", arch, "--smoke", "--steps", str(n), "--batch", str(B),
        "--seq", str(S), "--device", "cpu"])
    out = run(STEPS)
    printed = capsys.readouterr().out
    assert f"[launch] {arch}-smoke on mesh {{'data': 1, 'model': 1}}" \
        in printed
    assert "step    0 loss" in printed and f"{STEPS} steps in" in printed
    jcfg = jshapes.smoke_config(jget_config(arch))
    tcfg = tshapes.smoke_config(get_config(arch))
    par = JParallel(model_axis="model", data_axes=("data",),
                    mesh=jax.make_mesh((1, 1), ("data", "model")))
    key = jax.random.PRNGKey(0)
    jstep = jax.jit(jmake_train_step(jcfg, par, lr=LR))
    batch = lambda i: {"tokens": jax.random.randint(
        jax.random.fold_in(key, i), (B, S), 0, jcfg.vocab_size)}

    init = init_train_state(prng.PRNGKey(0), tcfg, device="cpu")
    after0 = run(1)["state"]
    for i, st in enumerate((init, after0)):
        js = JTrainState(ref_tree(st.params.state_dict(), jcfg, tcfg),
                         JAdamWState(jnp.int32(st.opt.step),
                                     ref_tree(st.opt.mu, jcfg, tcfg),
                                     ref_tree(st.opt.nu, jcfg, tcfg)))
        _, jm = jstep(js, batch(i))
        _close(out["losses"][i], float(jm["loss"]), (i, "loss"))
        _close(out["grad_norms"][i], float(jm["grad_norm"]), (i, "norm"))

    js = jinit_train_state(key, jcfg)
    drift = {k: torch.zeros(()) for k in as_state(js.params, tcfg)}
    for i in range(STEPS):
        before = AdamWState(i, as_state(js.opt.mu, tcfg), None)
        js, jm = jstep(js, batch(i))
        _close(out["losses"][i], float(jm["loss"]), (i, "trajectory loss"))
        gate = adamw_update_bound(
            before, AdamWState(i + 1, as_state(js.opt.mu, tcfg),
                               as_state(js.opt.nu, tcfg)), lr=LR,
            rel=TOL_REL)
        drift = {k: drift[k] + g for k, g in gate.items()}
    want, got = as_state(js.params, tcfg), out["state"].params.state_dict()
    for k, w in want.items():
        err = (got[k] - w).abs()
        assert bool((err <= TOL_REL * w.abs().max() + drift[k]).all()), k


def test_launcher_draws_the_reference_batches():
    """``draw_batch`` for the three frontends: ``randint``, ``normal`` and
    ``bernoulli(0.3)`` from the one key, as the reference's launcher draws
    them (bits equal; normals within a few ulps)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    k = np.asarray(key)
    tok = launch_train.draw_batch(get_config("qwen2-7b"), k, 2, 8, "cpu")
    assert np.array_equal(tok["tokens"].numpy(), np.asarray(
        jax.random.randint(key, (2, 8), 0, 152064)))
    cfg = tshapes.smoke_config(get_config("hubert-xlarge"))
    aud = launch_train.draw_batch(cfg, k, 2, 8, "cpu")
    assert np.array_equal(aud["mask"].numpy(), np.asarray(
        jax.random.bernoulli(key, 0.3, (2, 8))))
    assert np.array_equal(aud["labels"].numpy(), np.asarray(
        jax.random.randint(key, (2, 8), 0, cfg.vocab_size)))
    np.testing.assert_allclose(aud["frames"].numpy(), np.asarray(
        jax.random.normal(key, (2, 8, cfg.frontend_dim))), rtol=1e-6,
        atol=1e-6)
    vis = launch_train.draw_batch(
        tshapes.smoke_config(get_config("internvl2-1b")), k, 2, 8, "cpu")
    assert vis["patches"].shape == (2, 4, 64) and vis["tokens"].shape == (2,
                                                                          4)


def test_launcher_takes_moe_ep_for_olmoe():
    """olmoe-smoke through the launcher: every MoE layer of every step
    takes the expert-parallel path (the mesh names a model axis), and the
    losses are finite."""
    before = tmoe.moe_ep.calls
    out = launch_train.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps",
                             str(STEPS), "--batch", str(B), "--seq", str(S),
                             "--device", "cpu"])
    layers = tshapes.smoke_config(get_config("olmoe-1b-7b")).num_layers
    assert tmoe.moe_ep.calls - before == STEPS * layers
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == STEPS


def test_launcher_refuses_without_a_card(monkeypatch):
    """No fallback: without ``--device cpu`` and without a card, the
    launcher raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "xlstm-125m", "--smoke", "--steps",
                           "1"])


@pytest.fixture(scope="module")
def granite():
    """granite-20b-smoke (MQA: 4 q heads over 1 kv head), seeded."""
    cfg = tshapes.smoke_config(get_config("granite-20b"))
    assert cfg.num_heads // cfg.num_kv_heads == 4
    return cfg, init_lm(prng.PRNGKey(3), cfg, device="cpu")


def test_layout_fields_change_no_value(granite):
    """``gqa_repeat`` (k and v repeated to the q heads), ``qkv_spec``,
    ``resid_spec`` and ``logits_spec`` leave the logits and caches as they
    are, on the plain and the kernel wrapper's route; a spec of too many
    dimensions raises."""
    cfg, lm = granite
    mesh = make_host_mesh(1, 1, device="cpu")
    sh = lambda *s: NamedSharding(mesh, s)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    for kernels in (False, True):
        plain = tmoe.Parallel(use_kernels=kernels)
        laid = tmoe.Parallel(use_kernels=kernels, gqa_repeat=True,
                             qkv_spec=(sh("data", None, "model", None),
                                       sh("data", None, None, None)),
                             resid_spec=sh("data", "model", None),
                             logits_spec=sh("data", None, "model"))
        with torch.no_grad():
            want = lm(toks, plain, mode="prefill")
            got = lm(toks, laid, mode="prefill")
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[2], want[2]):
            assert a.k.shape[2] == cfg.num_kv_heads
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    with pytest.raises(ValueError, match="spec"):
        with torch.no_grad():
            lm(toks, tmoe.Parallel(logits_spec=(None,) * 4))


def test_decode_cache_carry_equals_scan_ys(granite):
    """Prefill, then 3 decode steps with each cache plumbing: the same
    logits and caches."""
    cfg, lm = granite
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    runs = {}
    for how in ("scan_ys", "carry"):
        par = tmoe.Parallel(decode_cache=how)
        with torch.no_grad():
            _, _, pre = lm(toks, par, mode="prefill")
            caches = lm.init_caches(2, 12)
            for c, p in zip(caches, pre):
                c.k[:, :8], c.v[:, :8] = p.k, p.v
            logits = []
            for i in range(3):
                lg, caches = lm.decode_step(toks[:, i:i + 1], caches, 8 + i,
                                            par)
                logits.append(lg)
        runs[how] = (torch.cat(logits, 1), caches)
    assert torch.equal(runs["carry"][0], runs["scan_ys"][0])
    for a, b in zip(runs["carry"][1], runs["scan_ys"][1]):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_the_reference(arch, shape):
    """Shapes and dtypes of every stand-in; decode caches per layer
    against the reference's stacked ones."""
    want = jinput_specs(jget_config(arch), JSHAPES[shape])
    got = input_specs(get_config(arch), INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    dt = lambda t: str(t.dtype).replace("torch.", "")
    if "batch" in want:
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k, w in want["batch"].items():
            assert got["batch"][k].shape == w.shape
            assert got["batch"][k].device.type == "meta"
            assert dt(got["batch"][k]) == str(w.dtype).replace("bool",
                                                                "bool")
        return
    for k in ("tokens", "pos"):
        assert got[k].shape == want[k].shape and dt(got[k]) == "int32"
    period = len(want["caches"])
    for i, c in enumerate(got["caches"]):
        w = want["caches"][f"p{i % period}"]
        assert type(c).__name__ == type(w).__name__
        for a, b in zip(c, w):
            assert a.shape == b.shape[1:] and dt(a) == str(b.dtype)


@pytest.mark.parametrize("px", [16, 224])
def test_denoiser_cost_equals_the_reference(px):
    for kw in ({}, {"fused": True}, {"fused": True, "bf16": True}):
        assert hlo_analysis.denoiser_cost(DiffusionConfig(), 8, px, **kw) \
            == jhlo.denoiser_cost(JDiffusionConfig(), 8, px, **kw)


def test_count_step_counts_a_matmul_and_its_backward():
    """One matmul is 2·M·N·K, its bytes its operands and result; under
    inference mode the composite ``linear`` is counted by its parts; a
    backward counts the two gradient matmuls."""
    M, N, K = 64, 16, 32
    a = torch.empty((M, K), device="meta")
    w = torch.empty((K, N), device="meta", requires_grad=True)
    mm = hlo_analysis.count_step(torch.mm, a, w.detach())
    assert mm.flops == 2 * M * N * K and mm.ops == 1
    assert mm.bytes == 4 * (M * K + K * N + M * N)
    with torch.inference_mode():
        lin = hlo_analysis.count_step(torch.nn.functional.linear, a,
                                      w.detach().T)
    assert lin.flops_by_op.get("mm") == 2 * M * N * K

    def fwd_bwd():
        (a @ w).sum().backward()

    both = hlo_analysis.count_step(fwd_bwd)
    assert both.flops_by_op["mm"] == 2 * 2 * M * N * K
    assert both.collective_bytes == 0 and "no collectives" in both.note


def test_roofline_terms_use_the_h100():
    t = hlo_analysis.roofline_terms(989e12, 3.35e12, 450e9)
    assert t == {"t_compute": 1.0, "t_memory": 1.0, "t_collective": 1.0}
    assert hlo_analysis.dominant_term({"t_compute": 1, "t_memory": 2,
                                       "t_collective": 0}) == "memory"


def test_dry_run_records_the_reference_checks(tmp_path):
    """xlstm-125m × decode_32k is ``ok`` on the 256-device meta mesh with
    the reference's record keys and t_compute below 1 ms; hubert-xlarge ×
    decode_32k is the documented ``skip``; both merge into ``--out``."""
    out = tmp_path / "dr.json"
    for arch in ("xlstm-125m", "hubert-xlarge"):
        dryrun.main(["--arch", arch, "--shape", "decode_32k", "--out",
                     str(out)])
    data = json.loads(out.read_text())
    ok = data["xlstm-125m|decode_32k|1pod|{}"]
    assert ok["status"] == "ok", ok
    assert RECORD_KEYS <= set(ok)
    assert ok["n_devices"] == 256 and ok["mesh"] == {"data": 16,
                                                     "model": 16}
    assert ok["flops_per_device"] > 0 and ok["bytes_per_device"] > 0
    assert 0 < ok["roofline"]["t_compute"] < 1e-3
    assert ok["bottleneck"] in ("compute", "memory", "collective")
    assert ok["memory"]["arg_bytes_analytic_per_device"] > 0
    skip = data["hubert-xlarge|decode_32k|1pod|{}"]
    assert skip["status"] == "skip" and "encoder-only" in skip["note"]
