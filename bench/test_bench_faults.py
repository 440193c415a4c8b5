"""A run driven on the CPU at a tiny size, past the harness's look for a
card, with the timed path broken underneath: ``correct`` must come out
false for each fault a cell can have, and true for the sound path.  (The
exchange between chips is a fault no one-chip cell can have.)"""
import contextlib
import time

import pytest
import torch

from bench import harness

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def jax_elsewhere_in_this_worker(monkeypatch):
    """Other test files of the suite load the JAX package into the same
    worker process, which a run refuses; these drives check what they
    check, and the import check itself is tested in a fresh interpreter
    (``test_bench_imports.py``) and below."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda names=None: [])


def tiny(workload: str) -> harness.Cell:
    """The cell at a CPU size, with its real limits."""
    cell = harness.find_cell(workload)
    if cell.traffic["driver"] == "synthesis_backlog":
        cell.config = dict(cell.config, image_size=16, d_model=32,
                           num_heads=2, num_layers=2)
        cell.traffic = dict(cell.traffic, steps=4, wave_images=8,
                            images_per_request=4, check_requests=2)
    else:
        cell.config = dict(cell.config, num_layers=2, d_model=64,
                           num_heads=4, num_kv_heads=4, head_dim=16,
                           vocab_size=300, padded_vocab=512, num_experts=8,
                           top_k=2, d_ff_expert=32, dtype="float32")
        cell.traffic = dict(cell.traffic, batch=[[8, 3], [16, 2], [24, 1]],
                            max_len=25, check_batches=2)
    return cell


def run(cell, seed=2 ** 31 + 5, seconds=0.3, trace=False):
    return harness.drive(cell, seed, seconds, trace, CPU, time.perf_counter())


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


# -- the D_syn cell -----------------------------------------------------------

def _state_unchanged():
    from repro_torch.kernels.cfg_fuse import ops
    return patched(ops, "cfg_update", lambda f: lambda x, *a, **k: x)


def _half_batch():
    from repro_torch.diffusion.dit import DiT

    def make(f):
        def forward(self, x, t, y=None):
            h = x.shape[0] // 2
            out = f(self, x[:h], t[:h], None if y is None else y[:h])
            return torch.cat([out, out.mean(0, keepdim=True).expand(
                x.shape[0] - h, *out.shape[1:])])
        return forward
    return patched(DiT, "forward", make)


def _answer_altered():
    from repro_torch.serve import synthesis

    def make(f):
        def sample(*a, **k):
            x = f(*a, **k).clone()
            x[0] = -x[0]
            return x
        return sample
    return patched(synthesis, "sample_cfg", make)


DSYN_FAULTS = {"state_unchanged": _state_unchanged,
               "half_batch": _half_batch, "answer_altered": _answer_altered}


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda names=None: ["jax"])
    with pytest.raises(harness.ForbiddenImport):
        run(tiny("olmoe-prefill-docs"))


@pytest.mark.parametrize("stage", ["reader", "check"])
def test_jax_loaded_by_a_reader_or_the_check_prints_no_result(
        monkeypatch, stage):
    """The import check comes after the metric readers and the check, so
    a module that either of them loads refuses the run."""
    loaded = {}
    if stage == "reader":
        real = harness.reader

        def reader(name):
            loaded["jax"] = True
            return real(name)
        monkeypatch.setattr(harness, "reader", reader)
    else:
        drv = harness.driver_class(tiny("dit224-uniform").traffic)
        real = drv.check

        def check(self, *a, **k):
            loaded["jax"] = True
            return real(self, *a, **k)
        monkeypatch.setattr(drv, "check", check)
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda names=None: sorted(loaded))
    with pytest.raises(harness.ForbiddenImport):
        run(tiny("dit224-uniform"))
    assert loaded


def test_dsyn_sound_run_is_correct():
    res = run(tiny("dit224-uniform"))
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(DSYN_FAULTS))
def test_dsyn_fault_is_caught(fault):
    cell = tiny("dit224-uniform")
    cell.traffic["check_requests"] = 8       # every row of the wave's pair
    with DSYN_FAULTS[fault]():
        res = run(cell)
    assert not res["correct"], res["check"]


# -- the prefill cell ---------------------------------------------------------

def _layer_returns_its_input():
    from repro_torch.models import moe
    return patched(moe, "moe_dense", lambda f: lambda p, c, x:
                   (torch.zeros_like(x), torch.zeros((), device=x.device)))


def _half_batch_lm():
    from repro_torch.models.transformer import LM

    def make(f):
        def forward(self, batch, *a, **k):
            h = max(batch.shape[0] // 2, 1)
            out = f(self, batch[:h], *a, **k)
            logits = out[0]
            fill = logits.mean(0, keepdim=True).expand(
                batch.shape[0] - h, *logits.shape[1:])
            return (torch.cat([logits, fill]),) + tuple(out[1:])
        return forward
    return patched(LM, "forward", make)


def _token_altered():
    from repro_torch.serve.engine import ServeEngine

    def make(f):
        def run_wave(self, wave, results):
            f(self, wave, results)
            wave[0].out[0] = (wave[0].out[0] + 1) % self.cfg.vocab_size
        return run_wave
    return patched(ServeEngine, "_run_wave", make)


def _logits_altered():
    from repro_torch.models.transformer import LM

    def make(f):
        def readout(self, x, *a, **k):
            out = f(self, x, *a, **k).clone()
            out[..., -1, :7] += 5.0
            return out
        return readout
    return patched(LM, "_readout", make)


def _layer_skips(rows):
    """Every layer leaves the ``rows`` of its output at their input, the
    shape kept: a fault that a median over tokens would not see."""
    from repro_torch.models.transformer import LM

    def make(f):
        def apply_layer(self, layer, x, *a, **k):
            out = f(self, layer, x, *a, **k)
            y = out[0].clone()
            y[rows(y)] = x[rows(y)]
            return (y,) + tuple(out[1:])
        return apply_layer
    return patched(LM, "_apply_layer", make)


PREFILL_FAULTS = {
    "layer_returns_its_input": _layer_returns_its_input,
    "half_batch": _half_batch_lm,
    "token_altered": _token_altered,
    "logits_altered": _logits_altered,
    "half_of_each_wave_skipped": lambda: _layer_skips(
        lambda y: (slice(None), slice(0, None, 2))),
    "half_of_the_requests_skipped": lambda: _layer_skips(
        lambda y: (slice(0, max(y.shape[0] // 2, 1)),)),
    "last_positions_skipped": lambda: _layer_skips(
        lambda y: (slice(None), -1))}


def test_prefill_sound_run_is_correct():
    res = run(tiny("olmoe-prefill-docs"))
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(PREFILL_FAULTS))
def test_prefill_fault_is_caught(fault):
    with PREFILL_FAULTS[fault]():
        res = run(tiny("olmoe-prefill-docs"))
    assert not res["correct"], res["check"]
