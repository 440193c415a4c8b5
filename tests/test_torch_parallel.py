"""The port's expert-parallel MoE (``models/moe.py::moe_ep``) and
``Parallel``'s mesh fields against the JAX package's, on the CPU.

Oracles:

* a 1×1 mesh: the reference's ``moe_ep`` (its ``shard_map``) in this
  process, at capacity factor 1.25 and 0.01 (the reference's
  ``test_capacity_drops_tokens``), and ``jax.grad`` of it;
* the (data, model) = (1, 2), (2, 1) and (2, 2) meshes: the reference run
  once in a child process with four forced host devices (this process's
  jax has one); the port's side runs on CPU meshes of two and four
  entries, as ``test_torch_topology.py`` builds them.

Tolerances: the output within 1e-5 of its largest value (fp32 sums in
another order; a token dropped or kept otherwise moves it by O(1)), aux
within 1e-6, the dropped (token, expert) pairs identical, gradients within
1e-5 of each one's largest element.
"""
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

from repro.models import moe as jmoe
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tmoe
from test_torch_moe import cfg_pair, port_moe
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
TOL, TOL_AUX = 1e-5, 1e-6
MESHES = ((1, 2), (2, 1), (2, 2))
CPU = torch.device("cpu")


def cpu_mesh(data: int, model: int) -> Mesh:
    return Mesh(np.array([[CPU] * model] * data, dtype=object),
                ("data", "model"))


def port_par(data: int = 1, model: int = 1, **kw) -> tmoe.Parallel:
    return tmoe.Parallel(model_axis="model", data_axes=("data",),
                         mesh=cpu_mesh(data, model), use_kernels=False, **kw)


def ref_par(data: int = 1, model: int = 1) -> jmoe.Parallel:
    return jmoe.Parallel(model_axis="model", data_axes=("data",),
                         mesh=jax.make_mesh((data, model), ("data", "model")))


def inputs(seed: int, B: int = 4, S: int = 8, d: int = 256):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def ref_drops(params, jcfg, x, D: int) -> np.ndarray:
    """The (data shard, token, expert) pairs the reference drops: per data
    shard, each expert's selected tokens past ``jnp.nonzero(size=cap)``."""
    m = jcfg.moe
    out = []
    for i, xs in enumerate(np.split(x, D)):
        flat = jnp.asarray(xs.reshape(-1, xs.shape[-1]))
        T = flat.shape[0]
        cap = max(1, int(T * m.top_k / m.num_experts * m.capacity_factor))
        gates, idx, _ = jmoe._route(params["w_router"], flat, m)
        for e in range(m.num_experts):
            w_t = jnp.sum(jnp.where(idx == e, gates, 0.0), axis=-1)
            sel = np.flatnonzero(np.asarray(w_t > 0))
            kept = np.asarray(jnp.nonzero(w_t > 0, size=cap,
                                          fill_value=T)[0])
            out += [(i, t, e) for t in sel if t not in kept]
    return np.array(sorted(out), dtype=np.int64).reshape(-1, 3)


def port_drops(mod, tcfg, x, D: int) -> np.ndarray:
    """The same pairs from the port's routing, per data shard
    (``moe.dropped_pairs`` at ``ep_capacity``)."""
    m = tcfg.moe
    xs = torch.from_numpy(x).reshape(D, -1, x.shape[-1])
    gates, idx, _ = tmoe.route(mod.w_router, xs, m)
    drop = tmoe.dropped_pairs(gates, idx, m.num_experts,
                              tmoe.ep_capacity(xs.shape[1], m))
    return torch.nonzero(drop).numpy()


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cf", [1.25, 0.01])
def test_moe_ep_on_a_unit_mesh_matches_the_reference(cf):
    """Output, aux and dropped pairs against the reference's ``moe_ep`` on
    a 1×1 mesh, at the config's capacity factor and at the reference
    test's 0.01 (most pairs dropped: capacity 1 row an expert)."""
    jcfg, tcfg = cfg_pair(capacity_factor=cf)
    params = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    x = inputs(7, B=2, S=16)
    want, jaux = jax.jit(lambda p, v: jmoe.moe_ep(p, jcfg, v, ref_par()))(
        params, jnp.asarray(x))
    mod = port_moe(params, tcfg)
    tmoe.moe_ep.record = []
    try:
        with torch.no_grad():
            got, aux = tmoe.moe_ep(mod, tcfg, torch.from_numpy(x),
                                   port_par())
        counted = int(tmoe.moe_ep.record[0])
    finally:
        tmoe.moe_ep.record = None
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(jaux)) < TOL_AUX
    drops = ref_drops(params, jcfg, x, 1)
    assert np.array_equal(port_drops(mod, tcfg, x, 1), drops)
    assert counted == len(drops)
    if cf < 1:
        assert len(drops) > 0.8 * x.shape[0] * x.shape[1] * jcfg.moe.top_k
    assert bool(torch.isfinite(got).all())


def test_moe_ep_gradients_match_jax_grad_on_a_unit_mesh():
    """Autograd through the port's ``moe_ep`` against ``jax.grad`` of the
    reference's at 1×1: every parameter's gradient and x's."""
    jcfg, tcfg = cfg_pair()
    params = jmoe.init_moe(jax.random.PRNGKey(8), jcfg)
    x = inputs(8, B=2, S=16)

    def jloss(p, v):
        out, aux = jmoe.moe_ep(p, jcfg, v, ref_par())
        return jnp.sum(out ** 2) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                       jnp.asarray(x))
    mod = port_moe(params, tcfg)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ep(mod, tcfg, xt, port_par())
    (out.square().sum() + 0.01 * aux).backward()
    for name, p in mod.named_parameters():
        assert _rel(p.grad, jg[name]) < TOL, name
    assert _rel(xt.grad, jgx) < TOL


@pytest.fixture(scope="module")
def reference_meshes(tmp_path_factory):
    """The reference's ``moe_ep`` on (1, 2), (2, 1) and (2, 2), run once in
    a child process that forces four host devices before jax starts.  The
    inputs are positive and the router leans to expert 0, so each data
    shard drops pairs (14 of 64 at capacity factor 1.25)."""
    d = tmp_path_factory.mktemp("moe_ep")
    jcfg, _ = cfg_pair()
    params = jmoe.init_moe(jax.random.PRNGKey(9), jcfg)
    w = np.asarray(params["w_router"]).copy()
    w[:, 0] += 0.003
    params = {**params, "w_router": jnp.asarray(w)}
    x = np.abs(inputs(9)) + 0.5
    np.savez(d / "in.npz", x=x, **{k: np.asarray(v)
                                   for k, v in params.items()})
    script = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.shapes import smoke_config
from repro.models import moe
cfg = smoke_config(get_config("olmoe-1b-7b"))
z = np.load(sys.argv[1] + "/in.npz")
p = {k: jnp.asarray(z[k]) for k in z.files if k != "x"}
out = {}
for D, M in json.loads(sys.argv[2]):
    mesh = jax.make_mesh((D, M), ("data", "model"))
    par = moe.Parallel(model_axis="model", data_axes=("data",), mesh=mesh)
    y, aux = jax.jit(lambda p, v: moe.moe_ep(p, cfg, v, par))(
        p, jnp.asarray(z["x"]))
    out[f"y{D}{M}"] = np.asarray(y)
    out[f"aux{D}{M}"] = np.asarray(aux)
np.savez(sys.argv[1] + "/out.npz", **out)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", script, str(d),
                           json.dumps(MESHES)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return params, x, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_ep_on_two_and_four_shards_matches_the_reference(
        reference_meshes, mesh):
    """On (data, model) = (1, 2), (2, 1) and (2, 2): the output, aux (the
    mean of the data shards' own aux) and the dropped pairs (each data
    shard's capacity from its own T) against the reference run on four
    forced host devices."""
    params, x, ref = reference_meshes
    D, M = mesh
    jcfg, tcfg = cfg_pair()
    mod = port_moe(params, tcfg)
    with torch.no_grad():
        got, aux = tmoe.moe_ep(mod, tcfg, torch.from_numpy(x),
                               port_par(D, M))
    assert _rel(got, ref[f"y{D}{M}"]) < TOL
    assert abs(float(aux) - float(ref[f"aux{D}{M}"])) < TOL_AUX
    drops = ref_drops(params, jcfg, x, D)
    assert len(drops) > 0
    assert np.array_equal(port_drops(mod, tcfg, x, D), drops)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_reduce_scatter_combine_equals_psum(mesh):
    """``moe_combine="reduce_scatter"`` sums each token chunk in the same
    ascending shard order: bit for bit the psum."""
    jcfg, tcfg = cfg_pair()
    mod = port_moe(jmoe.init_moe(jax.random.PRNGKey(10), jcfg), tcfg)
    x = torch.from_numpy(inputs(10))
    with torch.no_grad():
        a = tmoe.moe_ep(mod, tcfg, x, port_par(*mesh))
        b = tmoe.moe_ep(mod, tcfg, x, port_par(
            *mesh, moe_combine="reduce_scatter"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moe_ep_batch_not_sharded_sees_every_token():
    """``Parallel(batch_sharded=False)``: every shard routes all B rows,
    as the reference's replicated ``P()`` input; on a (2, 1) mesh that is
    the 1×1 result, capacity and aux from the whole T, where the split
    batch takes each half's."""
    jcfg, tcfg = cfg_pair()
    mod = port_moe(jmoe.init_moe(jax.random.PRNGKey(11), jcfg), tcfg)
    x = torch.from_numpy(inputs(11))
    with torch.no_grad():
        whole = tmoe.moe_apply(mod, tcfg, x, port_par(2, 1,
                                                      batch_sharded=False))
        unit = tmoe.moe_apply(mod, tcfg, x, port_par())
        split = tmoe.moe_apply(mod, tcfg, x, port_par(2, 1))
    assert torch.equal(whole[0], unit[0]) and torch.equal(whole[1], unit[1])
    assert not torch.equal(split[1], unit[1])


def test_moe_apply_takes_moe_ep_exactly_where_the_reference_does():
    """``moe_ep`` when ``Parallel`` names a model axis and a mesh, else
    ``moe_dense`` (the reference's ``moe_apply``), and the dense path at
    its own generous capacity keeps what a 1×1 ``moe_ep`` at capacity
    factor 8 keeps."""
    jcfg, tcfg = cfg_pair(capacity_factor=8.0)
    mod = port_moe(jmoe.init_moe(jax.random.PRNGKey(12), jcfg), tcfg)
    x = torch.from_numpy(inputs(12))
    cases = {"model axis and mesh": (port_par(), 1),
             "no mesh": (tmoe.Parallel(model_axis="model"), 0),
             "no model axis": (tmoe.Parallel(mesh=cpu_mesh(1, 1)), 0),
             "default": (tmoe.Parallel(), 0)}
    outs = {}
    for name, (par, ep) in cases.items():
        before = tmoe.moe_ep.calls
        with torch.no_grad():
            outs[name] = tmoe.moe_apply(mod, tcfg, x, par)
        assert tmoe.moe_ep.calls - before == ep, name
    want = outs["default"]
    got = outs["model axis and mesh"]
    assert _rel(got[0], want[0]) < TOL and abs(float(got[1] - want[1])) < 1e-6


def test_parallel_refuses_unknown_modes():
    with pytest.raises(ValueError, match="decode_cache"):
        tmoe.Parallel(decode_cache="inplace")
    with pytest.raises(ValueError, match="moe_combine"):
        tmoe.Parallel(moe_combine="all_to_all")
    assert tmoe.Parallel().model_size == 1
    assert port_par(2, 2).model_size == 2


def test_moe_ep_splits_experts_over_the_model_shards_devices():
    """Each model shard's pass runs on its own device: a mesh whose model
    shards are the CPU and the meta device leaves shard 1's work on meta,
    so its slab never reaches the CPU and the combine fails there."""
    _, tcfg = cfg_pair()
    mod = tmoe.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_()
    mesh = Mesh(np.array([[CPU, torch.device("meta")]], dtype=object),
                ("data", "model"))
    par = tmoe.Parallel(model_axis="model", data_axes=("data",), mesh=mesh)
    seen = []
    inner = tmoe.local_expert_pass

    def spy(params, cfg, x_flat, e_start, E_loc, *a):
        seen.append((x_flat.device.type, e_start, E_loc))
        return inner(params, cfg, x_flat, e_start, E_loc, *a)

    tmoe.local_expert_pass = spy
    try:
        with torch.no_grad(), pytest.raises((RuntimeError,
                                             NotImplementedError)):
            tmoe.moe_ep(mod, tcfg, torch.from_numpy(inputs(13)), par)
    finally:
        tmoe.local_expert_pass = inner
    assert seen == [("cpu", 0, 2), ("meta", 2, 2)]
