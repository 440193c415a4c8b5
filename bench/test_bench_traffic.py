"""The traffic files and the one generator that reads them."""
import json

import numpy as np
import pytest

from bench import harness, traffic

NAMES = sorted(p.stem for p in traffic.ROOT.glob("*.json"))
SEEDS = (0, 7, 2 ** 31 + 9, 2 ** 40 + 3)


@pytest.mark.parametrize("name", NAMES)
def test_traffic_file_parses_and_names_a_driver(name):
    spec = traffic.load(name)
    assert json.loads((traffic.ROOT / f"{name}.json").read_text()) == spec
    assert hasattr(harness.driver_class(spec), "run_window")


@pytest.mark.parametrize("seed", SEEDS)
def test_uploads_are_deterministic_by_seed(seed):
    spec = traffic.load("dsyn-uniform")
    a = [traffic.upload(spec, seed, i, 512) for i in (0, 59, 60, 123)]
    b = [traffic.upload(spec, seed, i, 512) for i in (0, 59, 60, 123)]
    for u, v in zip(a, b):
        assert np.array_equal(u.encoding, v.encoding)
        assert (u.guidance, u.steps, u.category) == (v.guidance, v.steps,
                                                     v.category)
    assert np.isclose(np.linalg.norm(a[0].encoding), 1.0, atol=1e-6)
    other = traffic.upload(spec, seed + 1, 0, 512)
    assert not np.array_equal(other.encoding, a[0].encoding)


@pytest.mark.parametrize("seed", SEEDS)
def test_no_encoding_triple_repeats_within_a_run(seed):
    spec = traffic.load("dsyn-uniform")
    seen = set()
    for i in range(3 * 60):
        u = traffic.upload(spec, seed, i, 512)
        seen.add((u.encoding.tobytes(), u.guidance, u.steps))
    assert len(seen) == 3 * 60


def test_a_round_is_every_client_and_category_once():
    spec = traffic.load("dsyn-uniform")
    us = [traffic.upload(spec, 1, i, 8) for i in range(120)]
    for r in (0, 1):
        pairs = {(u.client, u.category) for u in us if u.round == r}
        assert len(pairs) == spec["clients"] * spec["categories"] == 60
    assert {(u.guidance, u.steps, u.count) for u in us} == {(2.0, 50, 10)}


@pytest.mark.parametrize("seed", SEEDS)
def test_prompt_batches_have_fixed_sizes_and_seeded_tokens(seed):
    spec = traffic.load("prefill-docs")
    b1 = traffic.prompt_batch(spec, seed, 1, 50304)
    again = traffic.prompt_batch(spec, seed, 1, 50304)
    assert [len(p.tokens) for p in b1] == [len(p.tokens) for p in again]
    assert all(np.array_equal(p.tokens, q.tokens) for p, q in zip(b1, again))
    assert [len(p.tokens) for p in b1] == [4096] * 8
    assert sum(len(p.tokens) for p in b1) == sum(n * c for n, c in spec["batch"]) \
        == 32768
    assert 1 <= spec["check_batches"] and spec["max_len"] == 4096 + spec["max_new"]
    toks = np.concatenate([p.tokens for p in b1])
    assert toks.dtype == np.int32 and toks.min() >= 0 and toks.max() < 50304
    b2 = traffic.prompt_batch(spec, seed, 2, 50304)
    assert not np.array_equal(b1[0].tokens[:16], b2[0].tokens[:16])


def test_unknown_kind_is_refused(tmp_path, monkeypatch):
    (tmp_path / "odd.json").write_text('{"kind": "odd"}')
    monkeypatch.setattr(traffic, "ROOT", tmp_path)
    with pytest.raises(ValueError):
        traffic.load("odd")
