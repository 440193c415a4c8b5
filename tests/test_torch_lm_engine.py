"""The port's ``ServeEngine`` against the JAX package's on the same
parameters (``test_torch_lm.lm_pair``: gemma2-smoke and olmoe-smoke, whose
MoE FFNs route each decode step's B tokens, perturbed): the same
greedy tokens and the same ``stats`` for an equal-length wave, for mixed
lengths split into waves, with EOS, and batched against solo; and
jamba-smoke (one period: Mamba, attention and MoE layers) and xlstm-smoke
(mLSTM and sLSTM), whose decode carries recurrent states past the padded
KV caches, for mixed lengths split into waves.

Tokens are argmaxes of logits that agree to 2e-5 (``test_torch_lm``);
these prompts leave no top-2 gap that small, so the tokens must be equal.
The port runs with its kernel route (the flash wrapper's plain version on
the CPU) and its plain route; the reference with its default plain route.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.models.moe import Parallel
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.steps import make_prefill_step, make_serve_step
from test_torch_lm import lm_pair
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", params=["gemma2", "gqa_bias_qknorm",
                                        "olmoe"])
def pair(request):
    return lm_pair(request.param, seed=1)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lengths]


def _serve(engine_cls, cfg, model, jobs, **kw):
    eng = engine_cls(cfg, model, max_len=64, **kw)
    rids = [eng.submit(p, max_new=n, eos=e) for p, n, e in jobs]
    out = eng.run()
    return [out[r] for r in rids], eng.stats


def _both(pair, jobs, use_kernels=True):
    jcfg, tcfg, jp, lm = pair
    want = _serve(JServeEngine, jcfg, jp, jobs)
    got = _serve(ServeEngine, tcfg, lm, jobs,
                 par=Parallel(use_kernels=use_kernels))
    return got, want


@pytest.mark.parametrize("use_kernels", [True, False])
def test_equal_length_wave_matches_reference(pair, use_kernels):
    jobs = [(p, 6, None) for p in _prompts(0, [20, 20, 20])]
    (toks, stats), (want, want_stats) = _both(pair, jobs, use_kernels)
    assert toks == want and all(len(t) == 6 for t in toks)
    assert stats == want_stats == {"waves": 1, "prefilled": 3, "decoded": 15}


def test_mixed_lengths_split_into_waves_like_reference(pair):
    jobs = [(p, n, None) for p, n in zip(_prompts(2, [20, 12, 20, 12]),
                                         [4, 5, 3, 5])]
    (toks, stats), (want, want_stats) = _both(pair, jobs)
    assert toks == want and [len(t) for t in toks] == [4, 5, 3, 5]
    assert stats == want_stats and stats["waves"] == 2


def test_eos_stops_like_reference(pair):
    jcfg, tcfg, jp, lm = pair
    (prompt,) = _prompts(3, [20])
    (first,), _ = _serve(ServeEngine, tcfg, lm, [(prompt, 6, None)])
    eos = first[2]
    jobs = [(prompt, 6, eos), (_prompts(4, [20])[0], 6, None)]
    (toks, stats), (want, want_stats) = _both(pair, jobs)
    # decode stops at the first generated token equal to EOS (the
    # prefill's token is not checked, as in the reference)
    stop = next(i for i in range(1, 6) if first[i] == eos)
    assert toks == want and toks[0] == first[:stop + 1]
    assert stats == want_stats


def test_batched_wave_equals_solo_requests(pair):
    jcfg, tcfg, jp, lm = pair
    prompts = _prompts(5, [20, 20, 20])
    solo = [_serve(ServeEngine, tcfg, lm, [(p, 5, None)])[0][0]
            for p in prompts]
    batched, stats = _serve(ServeEngine, tcfg, lm,
                            [(p, 5, None) for p in prompts])
    assert batched == solo
    assert batched == _serve(JServeEngine, jcfg, jp,
                             [(p, 5, None) for p in prompts])[0]


def test_steps_are_the_models_prefill_and_greedy_decode(pair):
    """``make_prefill_step`` returns the last position's logits and the
    caches of a prefill; ``make_serve_step`` the padded-vocab argmax of a
    decode step, writing the caches in place."""
    jcfg, tcfg, jp, lm = pair
    toks = torch.as_tensor(np.stack(_prompts(6, [20, 20])))
    last, caches = make_prefill_step(lm)(toks)
    with torch.no_grad():
        logits, _, want = lm(toks, mode="prefill")
    assert torch.equal(last, logits[:, -1:])
    assert all(torch.equal(c.k, w.k) and torch.equal(c.v, w.v)
               for c, w in zip(caches, want))
    full = lm.init_caches(2, 24)
    for dst, src in zip(full, caches):
        dst.k[:, :20], dst.v[:, :20] = src.k, src.v
    nxt, step_logits, out = make_serve_step(lm)(toks[:, -1:], full, 20)
    assert out is full and bool(full[0].k[:, 20].any())
    assert torch.equal(nxt[:, 0], step_logits[:, -1].argmax(-1).int())


def test_serving_modules_import_without_jax():
    code = ("import sys; import repro_torch.serve.engine, "
            "repro_torch.serve.steps, repro_torch.models.transformer, "
            "repro_torch.kernels.rmsnorm.ops, repro_torch.convert, "
            "repro_torch.configs; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))] or 'repro' in sys.modules; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr + proc.stdout


@pytest.mark.parametrize("variant", ["jamba", "xlstm"])
def test_recurrent_mixers_serve_like_reference(variant):
    """Two waves (20- and 12-token prompts, 3 to 5 new tokens): the
    prefill's recurrent states pass through the engine's cache padding and
    each decode step stores the new ones; the same tokens and stats as the
    reference's engine."""
    pair = lm_pair(variant, seed=1)
    jobs = [(p, n, None) for p, n in zip(_prompts(2, [20, 12, 20, 12]),
                                         [4, 5, 3, 5])]
    (toks, stats), (want, want_stats) = _both(pair, jobs)
    assert toks == want and [len(t) for t in toks] == [4, 5, 3, 5]
    assert stats == want_stats and stats["waves"] == 2
