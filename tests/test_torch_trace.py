"""The port's tracer inside its layers, on the CPU: spans mirrored into a
``torch.profiler`` session, the per-thread current tracer the engines make
theirs, the disabled path, the MoE's dispatch counts, ``ServeEngine``'s
spans, and the served tokens, the MoE output and D_syn the same with
tracing on and off.  No jax: the models are drawn by the port."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.oscar import DiffusionConfig
from repro_torch.configs.shapes import smoke_config
from repro_torch.diffusion.dit import init_dit
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.models import moe as tmoe
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import init_lm
from repro_torch.obs import trace
from repro_torch.obs.trace import FakeClock, Tracer
from repro_torch.serve import SynthesisEngine
from repro_torch.serve.engine import ServeEngine
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _chrome(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    obj = json.loads(path.read_text())
    return obj["traceEvents"] if isinstance(obj, dict) else obj


def test_spans_open_while_the_profiler_records_are_in_its_trace(tmp_path):
    tr = Tracer()
    with tr.span("before"):                  # no profiler: no range
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serve.wave", B=2):
            with tr.span("serve.prefill"):
                torch.ones(4) + 1
            with tr.span("serve.pad_caches"):
                torch.zeros(4)
    ev = {e["name"]: e for e in _chrome(prof, tmp_path)
          if e.get("cat") == "user_annotation"}
    assert set(ev) == {"serve.wave", "serve.prefill", "serve.pad_caches"}
    outer = ev["serve.wave"]
    for name in ("serve.prefill", "serve.pad_caches"):
        e = ev[name]
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert ev["serve.prefill"]["ts"] + ev["serve.prefill"]["dur"] <= \
        ev["serve.pad_caches"]["ts"]
    depth = {s.name: s.depth for s in tr.spans}
    assert depth == {"before": 0, "serve.wave": 0, "serve.prefill": 1,
                     "serve.pad_caches": 1}


def test_current_is_per_thread_and_the_default_is_off():
    assert trace.current().enabled is False
    assert trace.default().enabled is False
    mine, seen = Tracer(), {}

    def other():
        seen["other"] = trace.current()

    with trace.using(mine):
        assert trace.current() is mine
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with trace.using(Tracer()) as inner:
            assert trace.current() is inner
        assert trace.current() is mine
    assert seen["other"].enabled is False and seen["other"] is not mine
    assert trace.current() is not mine


def _dit():
    dc = DiffusionConfig(d_model=32, num_layers=1, num_heads=2,
                         sample_timesteps=3)
    return init_dit(prng.PRNGKey(0), dc, 16, 3, device="cpu").eval(), \
        make_schedule(device="cpu")


def _enc(seed):
    e = np.random.default_rng(seed).normal(size=(512,))
    return (e / np.linalg.norm(e)).astype(np.float32)


def test_an_engine_is_current_in_its_drain_and_off_records_nothing():
    """The engine's tracer is current inside its drain (read at a wave
    boundary and inside the DiT's attention); an engine built without a
    tracer takes the process default, which, off, reads no clock and
    records nothing; D_syn is the same bits either way."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    model, sched = _dit()
    reads = []

    def clock():
        reads.append(1)
        return float(len(reads))

    off = Tracer(clock=clock, enabled=False)
    on = Tracer(clock=FakeClock(tick=1e-3))
    kept = len(trace.default().spans)
    outs, seen = {}, {}
    fa = fa_ops.flash_attention

    def spy(*a, **k):
        seen.setdefault("attention", trace.current())
        return fa(*a, **k)

    for name, tr in (("off", off), ("on", on), ("default", None)):
        eng = SynthesisEngine(model, sched, image_size=16, wave_size=8,
                              tracer=tr)
        rid = eng.submit(_enc(1), 0, 4)
        seen.clear()

        def poll():
            seen.setdefault("poll", trace.current())
            return False

        fa_ops.flash_attention = spy
        try:
            outs[name] = eng.run(prng.PRNGKey(3), poll=poll)[rid]
        finally:
            fa_ops.flash_attention = fa
        assert seen["poll"] is eng.tracer is seen["attention"]
    assert torch.equal(outs["off"], outs["on"])
    assert torch.equal(outs["off"], outs["default"])
    assert reads == [] and off.spans == [] and off.lifecycle == {}
    assert len(trace.default().spans) == kept
    assert off.span("wave.admit") is trace.NULL_SPAN
    names = [s.name for s in on.spans]
    assert names.count("wave.admit") == 2 and "wave.device" not in names
    assert trace.current().enabled is False


def _moe_cfg(**moe):
    cfg = smoke_config(get_config("olmoe-1b-7b"))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))


def _overflowing_moe():
    """16 experts top-2 over 32 tokens (capacity cdiv(64, 16)·4 = 16 rows),
    the router pushed to experts 0 and 1: each keeps 16 of its 32 tokens."""
    cfg = _moe_cfg(num_experts=16)
    lm = init_lm(prng.PRNGKey(3), cfg, device="cpu")
    moe = lm.layers[0].moe
    with torch.no_grad():
        moe.w_router[:, 0] += 0.5
        moe.w_router[:, 1] += 0.3
    rng = np.random.default_rng(4)
    x = torch.from_numpy((np.abs(rng.standard_normal((2, 16, cfg.d_model)))
                          + 0.5).astype(np.float32))
    return cfg, moe, x


def test_moe_dispatch_counts_pairs_rows_and_drops():
    cfg, moe, x = _overflowing_moe()
    T, k, E = 32, cfg.moe.top_k, cfg.moe.num_experts
    cap = tmoe.capacity(T, cfg.moe)
    tr = Tracer()
    with torch.no_grad():
        want, _ = tmoe.moe_dense(moe, cfg, x)
        with trace.using(tr):
            got, _ = tmoe.moe_dense(moe, cfg, x)
    assert torch.equal(got, want)
    spans = {s.name: s for s in tr.spans}
    assert [s.name for s in tr.spans] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe"]
    assert [s.depth for s in tr.spans] == [1, 1, 1, 1, 0]
    d = trace.resolve(spans["moe.dispatch"].attrs)
    gates, idx, _ = tmoe.route(moe.w_router, x.reshape(T, -1), cfg.moe)
    drops = int(tmoe.dropped_pairs(gates, idx, E, cap).sum())
    assert d == {"pairs": T * k, "expert_rows": E * cap, "dropped": drops}
    assert drops == 32 and isinstance(spans["moe.dispatch"].attrs["dropped"],
                                      torch.Tensor)


def test_an_expert_parallel_pass_counts_its_own_experts():
    """A local pass over experts 4..11 of 16 (as a model shard runs it):
    the pairs routed to them, their rows, and the drops among them."""
    cfg, moe, x = _overflowing_moe()
    T, E = 32, cfg.moe.num_experts
    cap = tmoe.capacity(T, cfg.moe)
    flat = x.reshape(T, -1)
    gates, idx, _ = tmoe.route(moe.w_router, flat, cfg.moe)
    # three in four tokens moved onto experts 4 and 5
    idx = torch.where(torch.arange(T)[:, None] % 4 == 0, idx, idx + 4)
    tr = Tracer()
    with torch.no_grad(), trace.using(tr):
        tmoe.local_expert_pass(moe, cfg, flat, 4, 8, cap, gates, idx)
    d = trace.resolve(next(s for s in tr.spans
                           if s.name == "moe.dispatch").attrs)
    here = (idx >= 4) & (idx < 12)
    drops = tmoe.dropped_pairs(gates, idx, E, cap)[:, 4:12].sum()
    assert d == {"pairs": int(here.sum()), "expert_rows": 8 * cap,
                 "dropped": int(drops)}
    assert d["dropped"] == 2 * (24 - cap)


def test_serve_engine_spans_nest_and_tokens_match_untraced():
    cfg = smoke_config(get_config("olmoe-1b-7b"))
    lm = init_lm(prng.PRNGKey(5), cfg, device="cpu").eval()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 8) for _ in range(2)] + \
        [rng.integers(0, 512, 5)]

    def serve(tracer):
        eng = ServeEngine(cfg, lm, max_len=16, par=Parallel(),
                          tracer=tracer)
        rids = [eng.submit(p, max_new=3) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids], eng

    tr = Tracer()
    traced, _ = serve(tr)
    plain, eng = serve(None)
    assert traced == plain and eng.tracer is trace.default()
    top = [(s.name, s.attrs) for s in tr.spans if s.depth == 0]
    assert top == [("serve.wave", {"B": 2, "L": 8}),
                   ("serve.wave", {"B": 1, "L": 5})]
    inner = [s.name for s in tr.spans if s.depth == 1]
    assert inner == ["serve.prefill", "serve.pad_caches",
                     "serve.first_token", "serve.decode_step",
                     "serve.decode_step"] * 2
    under = {s.name for s in tr.spans if s.depth == 2}
    assert under == {"flash_attention", "moe"}
    def inside(s, name):
        return any(p.name == name and p.start <= s.start and s.end <= p.end
                   for p in tr.spans)

    # attention through the flash wrapper in the prefill, plain in decode;
    # the MoE in both
    n = cfg.num_layers
    fa = [s for s in tr.spans if s.name == "flash_attention"]
    moe = [s for s in tr.spans if s.name == "moe"]
    assert len(fa) == 2 * n and all(inside(s, "serve.prefill") for s in fa)
    assert sum(inside(s, "serve.prefill") for s in moe) == 2 * n
    assert sum(inside(s, "serve.decode_step") for s in moe) == 4 * n
    assert len(moe) == 6 * n
