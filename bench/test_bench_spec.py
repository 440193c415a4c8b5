"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import re

import pytest

from bench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|top_k|experts_per_tok|d_model|"
                   r"d_ff)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert SPEC["command"][1].startswith("bench/")
    assert (harness.ROOT / SPEC["command"][1]).is_file()
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"])
    assert _line(conf["why"])
    assert conf["file"].startswith("bench/")
    body = harness.load_json(harness.ROOT / conf["file"])
    assert body["name"] == conf["name"]
    assert body["reduced"] == conf["reduced"]
    assert len(conf["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in conf["reduced"])
    assert (harness.BENCH / "references" /
            f"{body['reference']}.py").is_file()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    c = harness.find_cell(cell["name"], SPEC)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert all(m["moves"] in names for m in c.per_layer)
    assert c.limits["numbers"] and all(
        "limit" in v for v in c.limits["numbers"].values())


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        names = [g["name"] for g in group]
        assert len(set(names)) == len(names)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert _line(m["layer"]) and m["better"] in ("lower", "higher")
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert all(w in CELLS for w in m.get("workloads", CELLS))
    mod = harness.reader(m["name"])
    assert callable(mod.read)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_each_cell_reads_a_step_share_of_peak_beside_its_roofline():
    for cell in CELLS:
        c = harness.find_cell(cell, SPEC)
        names = [m["name"] for m in c.per_layer]
        if any(n.endswith("_roofline") for n in names):
            assert any("mfu" in n for n in names)
