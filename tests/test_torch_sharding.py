"""The LM's partition rules (``sharding/rules.py``), the production mesh
and placement (``launch/mesh.py``) and the dry run's per-device argument
bytes against the JAX package's, on the CPU.

Oracles: the reference's ``param_specs`` on ``jax.eval_shape`` trees of
all ten archs at full size, in the three modes; its ``batch_specs`` and
``cache_specs`` for every supported (arch, shape); its dry run's
per-device argument bytes, reproduced here from its ``_sharded_bytes``
(``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` on
import).  The port's leaves are its ``LM`` on the meta device; each is
held against the reference leaf ``convert.lm_state_items`` pairs it with,
its two entries swapped where the port stores the transpose and the
reference's leading ``num_groups`` entry dropped.  Every spec and byte
count must be equal exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs.shapes import resolve_decode_config as jresolve
from repro.configs.shapes import shape_supported as jsupported
from repro.models.transformer import init_lm as jinit_lm
from repro.optim import init_adamw as jinit_adamw
from repro.sharding import rules as jrules
from repro.utils import tree_map_with_path
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs import input_specs
from repro_torch.convert import lm_state_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, NamedSharding, make_host_mesh,
                                     make_production_mesh,
                                     make_serving_mesh, place)
from repro_torch.models.transformer import LM
from repro_torch.sharding import rules
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

JAX_AX = jrules.MeshAxes(data=("data",), model="model")
AX = rules.MeshAxes(data=("data",), model="model")
MODES = ("train", "serve1d", "serve2d")
SIZES = {"data": 16, "model": 16}           # the production mesh
PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
         if jsupported(jget_config(a), JSHAPES[s])[0]]


def _flat(tree, is_leaf=None) -> dict:
    """path → leaf, paths as the reference's ``tree_map_with_path`` joins
    them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _spec(p) -> tuple:
    return tuple(p)


def test_arch_ids_are_the_references():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("data", [("data",), ("pod", "data")],
                         ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference_leaf_for_leaf(arch, data):
    """All three modes on one pod and on two, every leaf: the port's spec
    is the reference's leaf's spec after the transpose and unstack
    mapping, and the leaf's shape maps the same way."""
    jax_ax = jrules.MeshAxes(data=data, model="model")
    ax = rules.MeshAxes(data=data, model="model")
    jcfg, cfg = jget_config(arch), get_config(arch)
    sds = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), jcfg))
    shapes = _flat(sds)
    paths = tree_map_with_path(lambda p, leaf: p, sds)
    pairing = {name: load for name, load in lm_state_items(paths, cfg)}
    lm = LM(cfg, device="meta")
    state = lm.state_dict()
    assert sorted(pairing) == sorted(state)
    for mode in MODES:
        want = _flat(jrules.param_specs(sds, jax_ax, mode=mode),
                     is_leaf=lambda x: isinstance(x, P))
        got = rules.param_specs(lm, ax, mode=mode)
        assert sorted(got) == sorted(state)
        for name, load in pairing.items():
            spec, shape = _spec(want[load.leaf]), shapes[load.leaf].shape
            if load.group is not None:
                assert spec[0] is None
                spec, shape = spec[1:], shape[1:]
            if load.transpose:
                spec = spec[::-1] if len(spec) == 2 else spec
                shape = shape[::-1]
            assert tuple(state[name].shape) == tuple(shape), name
            assert got[name] == spec, (mode, name, load.leaf)


def test_param_specs_of_a_sample_of_leaves():
    """Spot checks, written out: the vocab-parallel embedding, a
    transposed q projection, an expert slab (not transposed), a replicated
    norm, and serve1d dropping the data factor."""
    lm = LM(get_config("olmoe-1b-7b"), device="meta")
    train = rules.param_specs(lm, AX)
    assert train["embedding"] == ("model", "data")
    # the reference's wq/w (d, H·hd) is P(data, model); nn.Linear's (out, in)
    assert train["layers.3.mixer.wq.weight"] == ("model", "data")
    assert train["layers.3.moe.experts_up"] == ("model", "data", None)
    assert train["layers.3.norm1.scale"] == (None,)
    serve = rules.param_specs(lm, AX, mode="serve1d")
    assert serve["layers.3.mixer.wq.weight"] == ("model", None)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_batch_and_cache_specs_match_the_reference(arch, shape):
    """``batch_specs`` for train and prefill, ``cache_specs`` per layer for
    decode (the reference's stacked spec without its group entry), with the
    batch sharded where the global batch divides over 16 data shards."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshape, tshape = JSHAPES[shape], INPUT_SHAPES[shape]
    bs = jshape.global_batch % 16 == 0
    if jshape.kind != "decode":
        want = jrules.batch_specs(jcfg, jshape, JAX_AX, bs)
        got = rules.batch_specs(cfg, tshape, AX, bs)
        assert got == {k: _spec(v) for k, v in want.items()}
        return
    jcaches = jinput_specs(jcfg, jshape)["caches"]
    caches = input_specs(cfg, tshape)["caches"]
    want = jrules.cache_specs(jresolve(jcfg, jshape), jshape, JAX_AX, bs,
                              jcaches)
    got = rules.cache_specs(cfg, tshape, AX, bs, caches)
    period = len(want)
    assert len(got) == len(caches)
    for i, (c, s) in enumerate(zip(caches, got)):
        jc, js = jcaches[f"p{i % period}"], want[f"p{i % period}"]
        assert type(s).__name__ == type(js).__name__
        for t, spec, jt, jspec in zip(c, s, jc, js):
            assert tuple(t.shape) == tuple(jt.shape[1:])
            assert _spec(jspec)[0] is None and spec == _spec(jspec)[1:]


def _ref_sharded_bytes(sds_tree, spec_tree) -> float:
    """The reference dry run's ``_sharded_bytes`` on the 16 × 16 mesh."""
    total = 0.0
    leaves_s = jax.tree.leaves(sds_tree)
    leaves_p = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    for sds, spec in zip(leaves_s, leaves_p):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for n in names:
                shards *= SIZES[n]
        total += math.prod(sds.shape) * sds.dtype.itemsize / shards
    return total


def _ref_arg_bytes(arch: str, shape: str) -> float:
    """The reference's ``build`` up to ``arg_bytes``, on stand-ins."""
    jshape = JSHAPES[shape]
    cfg = jresolve(jget_config(arch), jshape)
    bs = jshape.global_batch % 16 == 0
    params = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), cfg))
    if jshape.kind != "train":
        params = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, cfg.act_dtype)
            if jnp.issubdtype(s.dtype, jnp.floating) else s, params)
    pspecs = jrules.param_specs(params, JAX_AX)
    if jshape.kind == "train":
        from repro.optim.optimizers import AdamWState
        from repro.train.steps import TrainState
        state = TrainState(params, jax.eval_shape(lambda: jinit_adamw(params)))
        return _ref_sharded_bytes(state, TrainState(
            pspecs, AdamWState(P(), pspecs, pspecs)))
    if jshape.kind == "prefill":
        return _ref_sharded_bytes(params, pspecs)
    caches = jinput_specs(cfg, jshape)["caches"]
    return (_ref_sharded_bytes(params, pspecs) + _ref_sharded_bytes(
        caches, jrules.cache_specs(cfg, jshape, JAX_AX, bs, caches)))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_dry_run_argument_bytes_match_the_reference(arch, shape):
    """Per-device argument bytes of every supported pair on the production
    mesh: the train state (fp32 weights, AdamW's int32 count and two
    moments), the serving weights cast to the activation dtype, plus the
    decode caches; exactly the reference's reckoning."""
    pair = dryrun.setup(arch, shape)
    assert pair.arg_bytes == _ref_arg_bytes(arch, shape)


def test_dry_run_sharded_bytes_divides_by_the_named_axes():
    mesh = make_production_mesh(device="meta")
    t = torch.empty((32, 64), device="meta")
    tree = {"a": t, "b": [t, t]}
    specs = {"a": ("model", "data"), "b": [(None, None), (("data",
                                                            "model"), None)]}
    assert dryrun._sharded_bytes(tree, specs, mesh) == 32 * 64 * 4 * (
        1 / 256 + 1 + 1 / 256)


def test_production_mesh_refuses_too_few_devices():
    """The reference's ``test_production_mesh_refuses_undersized_device_set``
    on the CPU (one device), and the meta mesh of the dry run."""
    with pytest.raises(ValueError, match="devices.*make_host_mesh"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_serving_mesh(hosts=2, data=256, model=16, device="cpu")
    mesh = make_production_mesh(device="meta")
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    two = make_production_mesh(multi_pod=True, device="meta")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="devices"):
        make_host_mesh(32, 32, device="meta")


def test_to_shardings_and_place_keep_the_tree():
    """``to_shardings`` maps every spec of a tree of dicts, lists and
    NamedTuples; ``place`` puts each leaf on its sharding's first data
    device (a 1×1 CPU mesh: the CPU) and moves an LM's parameters in
    place."""
    cfg = get_config("xlstm-125m").replace(num_layers=2)
    mesh = make_host_mesh(1, 1, device="cpu")
    caches = LM(cfg, device="cpu").init_caches(2, 8)
    specs = rules.cache_specs(cfg, INPUT_SHAPES["decode_32k"], AX, True,
                              caches)
    sh = rules.to_shardings(specs, mesh)
    assert type(sh[0]) is type(caches[0])
    assert all(isinstance(s, NamedSharding) for s in sh[0])
    assert sh[0][0].spec == specs[0][0]
    placed = place(caches, sh)
    assert all(torch.equal(a, b) for c, pc in zip(caches, placed)
               for a, b in zip(c, pc))
    lm = LM(cfg, device="cpu")
    assert place(lm, rules.to_shardings(rules.param_specs(lm, AX),
                                        mesh)) is lm
    assert {p.device.type for p in lm.parameters()} == {"cpu"}
    meta = Mesh(np.array([[torch.device("meta")]], dtype=object),
                ("data", "model"))
    moved = place({"x": torch.ones(3)}, {"x": NamedSharding(meta, (None,))})
    assert moved["x"].device.type == "meta"
