"""No run may load the JAX package or JAX, compared by whole top-level
module names; the references load nothing of the program."""
import os
import subprocess
import sys

import pytest

from bench import harness

ROOT = harness.ROOT


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.serve", "numpy"], []),
    (["repro.kernels", "repro_torch"], ["repro"]),
    (["jaxlib.xla_client", "jaxtyping", "reprox"], ["jaxlib"]),
    (["flax", "jax"], ["flax", "jax"]),
])
def test_forbidden_names_are_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_s_imports_load_no_jax_and_no_reference_package():
    code = """
import json, sys
from bench import harness, tracing, weights, traffic
from bench.drivers import synthesis_backlog, prefill_batches
import repro_torch.serve, repro_torch.serve.engine, repro_torch.models.moe
import repro_torch.models.transformer, repro_torch.diffusion.dit
spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in spec["workloads"]:
    cell = harness.find_cell(w["name"], spec)
    harness.driver_class(cell.traffic)
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
    harness.regions_of(cell.per_layer)
print(json.dumps(harness.forbidden_modules()))
"""
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_references_import_nothing_of_the_program():
    code = """
import sys
import bench.references.dit, bench.references.moe_lm
import bench.references.threefry
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"repro", "repro_torch", "jax", "jaxlib", "flax"}))
"""
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_fails_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "dit224-uniform", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
