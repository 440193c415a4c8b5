"""The PyTorch port as a package: it stands alone (no jax, nothing of the
JAX package), mirrors the reference configs field for field, refuses to
pick a device it does not have, and reproduces the reference's respacing
and schedule."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import oscar as jcfg
from repro.diffusion import guidance as jguid
from repro.diffusion import schedule as jsched
from repro_torch import utils
from repro_torch.configs import oscar as tcfg
from repro_torch.core.experiment import Experiment
from repro_torch.diffusion.ddpm import pretrain_dm
from repro_torch.diffusion import dit as tdit
from repro_torch.diffusion import guidance as tguid
from repro_torch.diffusion import schedule as tsched
from repro_torch.models.classifiers import init_classifier
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax_or_reference():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m.split('.')[0] == 'ml_dtypes')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 20


def test_launch_modules_import_without_jax_and_set_nothing():
    """The launcher, the dry run, the accounting, the mesh and the
    partition rules import no jax; importing the dry run sets no
    ``XLA_FLAGS`` (the reference's sets them, so it cannot be imported
    beside jax)."""
    mods = ["repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis", "repro_torch.launch.mesh",
            "repro_torch.sharding.rules"]
    assert set(mods) <= set(MODULES)
    code = ("import importlib, json, os, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps([sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.split('.')[0] == 'repro'), "
            "os.environ.get('XLA_FLAGS')]))")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], None]


def test_source_has_no_jax_or_reference_import():
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro", "flax"), \
                    f"{path}: imports {name}"


@pytest.mark.parametrize("name", ["DataConfig", "DiffusionConfig",
                                  "OscarConfig"])
def test_config_fields_and_defaults_match_reference(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    rf, pf = dataclasses.fields(ref), dataclasses.fields(port)
    assert [f.name for f in rf] == [f.name for f in pf]
    r, p = ref(), port()
    for f in rf:
        rv, pv = getattr(r, f.name), getattr(p, f.name)
        if dataclasses.is_dataclass(rv):
            assert dataclasses.asdict(rv) == dataclasses.asdict(pv)
        else:
            assert rv == pv, f.name


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.default_device()
    with pytest.raises(RuntimeError):
        utils.resolve_device(None)
    assert utils.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given, the models, the schedule, pretraining and the
    ``Experiment`` go to the card, so without one they raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dc = tcfg.DiffusionConfig(d_model=32, num_layers=1, num_heads=2)
    key = np.array([0, 1], np.uint32)
    images, conds = np.zeros((2, 16, 16, 3)), np.zeros((2, 512))
    for build in (lambda: tdit.DiT(dc, 16, 3), tsched.make_schedule,
                  lambda: tdit.DiT(dc, 16, 3, device="cuda"),
                  lambda: tdit.init_dit(key, dc, 16, 3),
                  lambda: init_classifier(key, "vit_b16", 3),
                  lambda: pretrain_dm(key, dc, images, conds, image_size=16,
                                      channels=3, steps=1),
                  lambda: Experiment(verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert tsched.make_schedule(device="cpu").betas.device.type == "cpu"
    assert tdit.DiT(dc, 16, 3, device="cpu").null_y.device.type == "cpu"


def _reference_sampler_trajectories(T: int):
    """The reference's ``respaced_ts(T, n)`` for n = 1..T, each traced
    inside a jit as its ``sample_cfg`` traces it, all in one compile.  Each
    sits behind an optimization barrier, so XLA compiles it as the lone
    fusion a jitted sampler compiles: the values equal separate jits'
    (checked below; ``test_torch_sampler`` checks the sampler itself)."""
    def many():
        return [jax.lax.optimization_barrier(jguid.respaced_ts(T, n))
                for n in range(1, T + 1)]
    return [np.asarray(o) for o in jax.jit(many)()]


def test_respaced_ts_equals_reference_for_every_step_count():
    T = 1000
    for n, ref in enumerate(_reference_sampler_trajectories(T), start=1):
        assert np.array_equal(tguid.respaced_ts(T, n).numpy(), ref), n
    # step counts whose float32 linspace lands on exact .5 ties, each in
    # a jit of its own (15: rounded twice; 19, 27: once)
    for n in (1, 2, 15, 19, 27, 50, 1000):
        ref = jax.jit(lambda n=n: jguid.respaced_ts(T, n))()
        assert np.array_equal(tguid.respaced_ts(T, n).numpy(),
                              np.asarray(ref)), n
    with pytest.raises(ValueError):
        tguid.respaced_ts(T, T + 1)


def test_reference_eager_respacing_differs_from_its_sampler():
    """A fault of the reference, logged in ROADMAP: its ``respaced_ts``
    called eagerly returns another trajectory than its jitted sampler
    visits at some step counts.  The port follows the sampler."""
    T = 1000
    for n in (19, 27):
        assert not np.array_equal(np.asarray(jguid.respaced_ts(T, n)),
                                  tguid.respaced_ts(T, n).numpy()), n
    for n in (15, 50):
        assert np.array_equal(np.asarray(jguid.respaced_ts(T, n)),
                              tguid.respaced_ts(T, n).numpy()), n


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedule_and_coeffs_match_reference(kind):
    ref = jsched.make_schedule(1000, kind)
    port = tsched.make_schedule(1000, kind, device="cpu")
    for name in ("betas", "alphas", "alpha_bar", "sqrt_ab"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    # √(1−ᾱ) takes the root of a cancellation: one ulp of ᾱ ≈ 1 moves it
    # by ~3e-6, so it is held through its square, 1 − ᾱ.
    np.testing.assert_allclose(port.sqrt_1mab.numpy() ** 2,
                               np.asarray(ref.sqrt_1mab) ** 2, rtol=0,
                               atol=1e-6)
    for n in (4, 50):
        ra = jguid.ancestral_coeffs(ref, jguid.respaced_ts(1000, n))
        pa = tguid.ancestral_coeffs(port, tguid.respaced_ts(1000, n))
        for r, p in zip(ra, pa):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-6)


def test_q_sample_matches_reference():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 500, 999])
    ref = jsched.q_sample(jsched.make_schedule(), jnp.asarray(x0),
                          jnp.asarray(t), jnp.asarray(noise))
    port = tsched.q_sample(tsched.make_schedule(device="cpu"),
                           torch.from_numpy(x0), torch.from_numpy(t),
                           torch.from_numpy(noise))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)
