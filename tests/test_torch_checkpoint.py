"""The port's checkpoints (``repro_torch.checkpoint.io``): the cases of
``test_checkpoint_io.py`` for the port, and checkpoints crossing between
the packages in both directions (a DM written by either loads into the
other), with equal manifests."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs.oscar import DiffusionConfig as JDiffusionConfig
from repro.diffusion import dit as jdit
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.convert import dit_state_from_jax, dit_tree_from_state
from repro_torch.diffusion import dit as tdit
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DIT = dict(d_model=32, num_layers=2, num_heads=2)


def _tree():
    return {
        "w_f32": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
        "w_bf16": (torch.arange(8, dtype=torch.float32) / 3).to(
            torch.bfloat16),
        "step": torch.tensor(17, dtype=torch.int32),
        "nested": {"b_f16": torch.ones((4,), dtype=torch.float16) * 0.5,
                   "list": [np.arange(3, dtype=np.int64),
                            np.float32([1.5, -2])]},
    }


def _bits(t) -> bytes:
    t = torch.as_tensor(t)
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def test_dtypes_round_trip_exactly(tmp_path):
    tree = _tree()
    p = tmp_path / "ck"
    ckpt.save_pytree(tree, p, meta={"note": "dtype test"})
    loaded = ckpt.load_pytree(tree, p)
    want, got = ckpt.tree_paths(tree), ckpt.tree_paths(loaded)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, a), (_, b) in zip(want, got):
        a = torch.as_tensor(a)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        # bit for bit: bf16 must not detour through f32 rounding
        assert _bits(a) == _bits(b), k
    assert isinstance(loaded["nested"]["list"], list)


def test_manifest_records_dtypes_and_jax_key_order(tmp_path):
    p = tmp_path / "ck"
    ckpt.save_pytree(_tree(), p)
    manifest = json.loads(p.with_suffix(".json").read_text())
    assert manifest["dtypes"]["w_bf16"] == "bfloat16"
    assert manifest["dtypes"]["w_f32"] == "float32"
    assert manifest["dtypes"]["nested/list/0"] == "int64"
    assert set(manifest["dtypes"]) == set(manifest["keys"])
    assert manifest["keys"] == ["nested/b_f16", "nested/list/0",
                                "nested/list/1", "step", "w_bf16", "w_f32"]
    assert manifest["meta"] == {}


def test_bf16_stored_as_raw_bits_not_pickle(tmp_path):
    p = tmp_path / "ck"
    ckpt.save_pytree(_tree(), p)
    with np.load(p.with_suffix(".npz"), allow_pickle=False) as z:
        assert z["w_bf16"].dtype == np.uint16


@pytest.mark.parametrize("key,bad", [("w_f32", "float64"),
                                     ("w_bf16", "float16"),
                                     ("step", "bfloat16")])
def test_load_validates_dtype_against_manifest(tmp_path, key, bad):
    """A dtype the npz does not hold raises, also a same-width native
    dtype recorded for raw bf16 bits (they are never reinterpreted)."""
    tree = _tree()
    p = tmp_path / "ck"
    ckpt.save_pytree(tree, p)
    manifest = json.loads(p.with_suffix(".json").read_text())
    manifest["dtypes"][key] = bad
    p.with_suffix(".json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="inconsistent with manifest"):
        ckpt.load_pytree(tree, p)


def test_missing_key_and_shape_mismatch_raise(tmp_path):
    p = tmp_path / "ck"
    ckpt.save_pytree({"a": torch.ones(3)}, p)
    with pytest.raises(KeyError, match="missing key b"):
        ckpt.load_pytree({"a": torch.ones(3), "b": torch.ones(1)}, p)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree({"a": torch.ones(4)}, p)
    assert ckpt.exists(p) and not ckpt.exists(tmp_path / "other")


def test_legacy_manifest_without_dtypes_still_loads(tmp_path):
    tree = {"w": torch.ones(3)}
    p = tmp_path / "ck"
    ckpt.save_pytree(tree, p)
    manifest = json.loads(p.with_suffix(".json").read_text())
    del manifest["dtypes"]
    p.with_suffix(".json").write_text(json.dumps(manifest))
    loaded = ckpt.load_pytree(tree, p)
    assert torch.equal(loaded["w"], torch.ones(3))


# -- across the packages -------------------------------------------------------

@pytest.fixture(scope="module")
def ref_dit():
    return jax.jit(jdit.init_dit, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(2), JDiffusionConfig(**DIT), 16, 3)


def test_reference_checkpoint_loads_into_the_port(tmp_path, ref_dit):
    p = tmp_path / "dm"
    jckpt.save_pytree(ref_dit, p, meta={"steps": 3})
    template = tdit.init_dit_tree(np.asarray(jax.random.PRNGKey(9)),
                                  DiffusionConfig(**DIT), 16, 3)
    tree = ckpt.load_pytree(template, p)
    model = tdit.dit_from_tree(tree, DiffusionConfig(**DIT), 16, 3,
                               device="cpu")
    want = dit_state_from_jax(jax.tree.map(np.asarray, ref_dit))
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_port_checkpoint_loads_through_the_reference(tmp_path, ref_dit):
    model = tdit.init_dit(np.asarray(jax.random.PRNGKey(3)),
                          DiffusionConfig(**DIT), 16, 3, device="cpu")
    tree = dit_tree_from_state(model.state_dict())
    p, q = tmp_path / "port", tmp_path / "ref"
    ckpt.save_pytree(tree, p, meta={"steps": 3})
    loaded = jckpt.load_pytree(ref_dit, p)
    for (k, a), (_, b) in zip(ckpt.tree_paths(tree),
                              jax.tree_util.tree_flatten_with_path(loaded)[0]):
        assert np.array_equal(a, np.asarray(b)), k
    # the same tree written by the reference: the same manifest
    jckpt.save_pytree(jax.tree.map(jnp.asarray, tree), q, meta={"steps": 3})
    mp = json.loads(p.with_suffix(".json").read_text())
    mq = json.loads(q.with_suffix(".json").read_text())
    assert mp == mq
    assert mp["keys"][:3] == ["blocks/0/mod/b", "blocks/0/mod/w",
                              "blocks/0/w_down/b"]
    # bf16 leaves cross as raw bits too
    half = {"w": jnp.arange(5, dtype=jnp.float32).astype(jnp.bfloat16) / 3}
    jckpt.save_pytree(half, q)
    got = ckpt.load_pytree(half, q)["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(half["w"]).view(np.uint16))
    ckpt.save_pytree({"w": got}, p)
    back = jckpt.load_pytree(half, p)["w"]
    assert back.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back).view(np.uint16),
                          np.asarray(half["w"]).view(np.uint16))


def test_dit_tree_round_trips_through_the_state(ref_dit):
    state = dit_state_from_jax(jax.tree.map(np.asarray, ref_dit))
    tree = dit_tree_from_state(state)
    assert ckpt.tree_paths(tree)[0][0] == "blocks/0/mod/b"
    again = dit_state_from_jax(tree)
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert len(tree["blocks"]) == DIT["num_layers"]
