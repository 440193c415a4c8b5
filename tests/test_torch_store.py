"""The port's ``SynthesisStore`` against the JAX package's: the same
operations give the same files, so a store written by either package is
read by the other (rows and manifest bit for bit, equal slugs); LRU
eviction picks the same victims; corrupt shards are quarantined and
miss; and the crash orderings of eviction and quarantine (manifest
rewritten before any file is unlinked or moved), adapted from the
reference's ``tests/test_synthesis_service.py`` and
``tests/test_faults.py``.  Rows are synthetic: the store never looks
inside them."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.store import SynthesisStore as JStore
from repro.serve.store import _slug as jslug
from repro_torch.serve.store import SynthesisStore, _slug
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SHAPE = (16, 16, 3)
PER = int(np.prod(SHAPE)) * 4          # bytes of one row


def _rows(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, *SHAPE)).astype(np.float32)


def _keys():
    return [(f"{i:040x}", 2.0 + i, 3 + i) for i in range(3)] + \
        [("uncond:4", 0.0, 3)]


def _fill(cls, root, *, as_tensor=False):
    """Four entries, one grown by a second put, one read back (an LRU
    touch): the same operations in either package."""
    st = cls(root)
    keys = _keys()
    for i, k in enumerate(keys):
        rows = _rows(i, 2 + i)
        st.put(k, torch.from_numpy(rows) if as_tensor else rows)
    st.put(keys[0], _rows(9, 5))             # a shard only ever grows
    st.flush()
    st.get(keys[1])
    return st


@pytest.mark.parametrize("writer", ["port", "port_tensors", "reference"])
def test_a_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    want = _fill(JStore, tmp_path / "ref")
    want.flush()
    if writer == "reference":
        root = tmp_path / "ref"
        reader = SynthesisStore(root)
    else:
        root = tmp_path / "port"
        got = _fill(SynthesisStore, root, as_tensor=writer == "port_tensors")
        got.flush()
        # the same files: manifest JSON and shard names, bit for bit
        assert (root / "manifest.json").read_text() == \
            (tmp_path / "ref" / "manifest.json").read_text()
        reader = JStore(root)
    assert sorted(p.name for p in (root / "shards").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref" / "shards").iterdir())
    keys = _keys()
    for k in keys:
        assert _slug(k) == jslug(k)
        assert k in reader
    expect = [_rows(9, 5), _rows(1, 3), _rows(2, 4), _rows(3, 5)]
    for k, rows in zip(keys, expect):
        got_rows = reader.get(k)
        assert isinstance(got_rows, np.ndarray)
        assert got_rows.dtype == np.float32
        assert np.array_equal(got_rows, rows)
    assert reader.get(("f" * 40, 2.0, 3)) is None
    assert len(reader) == 4 and reader.total_bytes() == 17 * PER


def test_lru_evict_picks_the_references_victims(tmp_path):
    out = []
    for cls, name in ((JStore, "ref"), (SynthesisStore, "port")):
        st = _fill(cls, tmp_path / name)
        st.get(_keys()[0])                      # now the most recent
        victims = st.evict(9 * PER)
        cold = cls(tmp_path / name)
        out.append((victims, sorted(cold._manifest["entries"]),
                    sorted(p.name for p in (tmp_path / name / "shards")
                           .glob("*.npz")), cold.total_bytes()))
        assert st.evict(10 ** 9) == []
    assert out[0] == out[1]
    victims, live, files, total = out[1]
    assert len(victims) == 2 and total <= 9 * PER
    assert files == sorted(f"{s}.npz" for s in live)


def test_evicted_keys_stay_dead_after_another_handles_flush(tmp_path):
    """Tombstones: a handle that evicted a key does not merge it back from
    a manifest another handle rewrote."""
    a = _fill(SynthesisStore, tmp_path / "s")
    b = SynthesisStore(tmp_path / "s")
    victims = a.evict(0)
    assert len(victims) == 4
    b.put(("e" * 40, 1.0, 2), _rows(5, 1))
    b.flush()                                   # b still lists the victims
    a._write_manifest()
    cold = SynthesisStore(tmp_path / "s")
    assert len(cold) == 1 and cold.get(("e" * 40, 1.0, 2)) is not None


@pytest.mark.parametrize("damage", ["garbage", "truncated", "wrong_key",
                                    "wrong_shape"])
def test_corrupt_shards_are_quarantined_as_the_references(tmp_path, damage):
    """A damaged shard or manifest entry never raises: the entry leaves
    the manifest, the file moves to ``quarantine/``, the key misses, and a
    later put heals the store; the reference does the same."""
    key = _keys()[2]
    seen = []
    for cls, name in ((JStore, "ref"), (SynthesisStore, "port")):
        root = tmp_path / name
        _fill(cls, root).flush()
        slug = _slug(key)
        shard = root / "shards" / f"{slug}.npz"
        if damage == "garbage":
            shard.write_bytes(b"\x00garbage npz")
        elif damage == "truncated":
            shard.write_bytes(shard.read_bytes()[:300])
        else:
            man = json.loads((root / "manifest.json").read_text())
            ent = man["entries"][slug]
            if damage == "wrong_key":
                ent["key"]["steps"] += 1
            else:
                ent["shape"][1] += 1
            (root / "manifest.json").write_text(json.dumps(man))
        st = cls(root)
        assert st.get(key) is None
        assert st.metrics.get("store.quarantined") == 1
        assert (root / "quarantine" / f"{slug}.npz").exists()
        cold = cls(root)
        assert key not in cold and len(cold) == 3
        st.put(key, _rows(2, 4))
        st.flush()
        assert np.array_equal(cls(root).get(key), _rows(2, 4))
        seen.append(sorted(cold._manifest["entries"]))
    assert seen[0] == seen[1]


def test_a_shard_longer_than_its_entry_serves_the_entrys_prefix(tmp_path):
    """A crash between the shard's rename and the manifest's leaves more
    rows on disk than recorded: the recorded prefix is served; fewer
    rows than recorded is a miss."""
    st = SynthesisStore(tmp_path / "s")
    key = _keys()[0]
    st.put(key, _rows(0, 4))
    st.flush()
    man = json.loads((tmp_path / "s" / "manifest.json").read_text())
    st.put(key, _rows(0, 6))
    st.flush()
    (tmp_path / "s" / "manifest.json").write_text(json.dumps(man))
    assert np.array_equal(SynthesisStore(tmp_path / "s").get(key),
                          _rows(0, 6)[:4])
    man["entries"][_slug(key)]["count"] = 7
    (tmp_path / "s" / "manifest.json").write_text(json.dumps(man))
    assert SynthesisStore(tmp_path / "s").get(key) is None


def test_evict_crash_between_manifest_and_unlink(tmp_path, monkeypatch):
    """Dying after the manifest rewrite, before the victims' files go:
    the reopened store references no missing shard and every survivor
    loads; the victims' files are orphans."""
    st = _fill(SynthesisStore, tmp_path / "s")
    real_unlink = Path.unlink

    def dying_unlink(self, *a, **kw):
        if self.suffix == ".npz":
            raise RuntimeError("crashed between manifest write and unlink")
        return real_unlink(self, *a, **kw)

    monkeypatch.setattr(Path, "unlink", dying_unlink)
    with pytest.raises(RuntimeError, match="crashed"):
        st.evict(9 * PER)
    monkeypatch.undo()
    cold = SynthesisStore(tmp_path / "s")
    assert len(cold) == 2
    for ent in cold._manifest["entries"].values():
        key = (ent["key"]["encoding_sha1"], ent["key"]["guidance"],
               ent["key"]["steps"])
        assert len(cold.get(key)) == ent["count"]
    assert len(list((tmp_path / "s" / "shards").glob("*.npz"))) == 4


def test_evict_crash_before_manifest_write_loses_nothing(tmp_path,
                                                         monkeypatch):
    st = _fill(SynthesisStore, tmp_path / "s")

    def dying_write():
        raise RuntimeError("crashed before manifest write")

    monkeypatch.setattr(st, "_write_manifest", dying_write)
    with pytest.raises(RuntimeError, match="before manifest"):
        st.evict(0)
    monkeypatch.undo()
    cold = SynthesisStore(tmp_path / "s")
    assert len(cold) == 4
    assert np.array_equal(cold.get(_keys()[3]), _rows(3, 5))


def test_quarantine_crash_between_manifest_and_move(tmp_path, monkeypatch):
    """Dying after the manifest heals, before the corrupt file moves: the
    reopened store misses the key (never reads the garbage), and a put
    heals around the orphan."""
    st = _fill(SynthesisStore, tmp_path / "s")
    key = _keys()[1]
    (tmp_path / "s" / "shards" / f"{_slug(key)}.npz").write_bytes(b"junk")
    st = SynthesisStore(tmp_path / "s")
    real_replace = os.replace

    def dying_replace(src, dst, *a, **kw):
        if os.path.basename(os.path.dirname(str(dst))) == "quarantine":
            raise RuntimeError("crashed between manifest write and move")
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(RuntimeError, match="crashed"):
        st.get(key)
    monkeypatch.undo()
    cold = SynthesisStore(tmp_path / "s")
    assert len(cold) == 3 and cold.get(key) is None
    cold.put(key, _rows(1, 3))
    cold.flush()
    assert np.array_equal(SynthesisStore(tmp_path / "s").get(key),
                          _rows(1, 3))


def test_quarantine_crash_before_manifest_write_loses_nothing(tmp_path,
                                                              monkeypatch):
    st = _fill(SynthesisStore, tmp_path / "s")
    key = _keys()[1]
    shard = tmp_path / "s" / "shards" / f"{_slug(key)}.npz"
    shard.write_bytes(b"junk")
    st = SynthesisStore(tmp_path / "s")

    def dying_write():
        raise RuntimeError("crashed before manifest write")

    monkeypatch.setattr(st, "_write_manifest", dying_write)
    with pytest.raises(RuntimeError, match="before manifest"):
        st.get(key)
    monkeypatch.undo()
    assert shard.exists() and len(SynthesisStore(tmp_path / "s")) == 4
    cold = SynthesisStore(tmp_path / "s")
    assert cold.get(key) is None
    assert cold.metrics.get("store.quarantined") == 1
