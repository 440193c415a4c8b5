"""The DeepSeek-V3 block (moonlight-16b-a3b's: latent attention with its
latent cache, a leading dense layer, sigmoid routing with a selection bias
and shared experts) at a small size on the CPU, against the benchmark's
plain reference (``bench/references/mla_moe_lm.py``) on seeded weights.
The JAX package has no such block, so nothing here is held against it."""
import dataclasses

import numpy as np
import pytest
import torch

from bench import weights
from bench.drivers.prefill_batches_mla import Driver
from bench.references import mla_moe_lm
from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import moe as tmoe
from repro_torch.models.mla import LatentCache
from repro_torch.models.moe import Parallel
from repro_torch.models.transformer import LM, init_lm
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import ServeEngine

CPU = torch.device("cpu")
# moonlight's keys at a small size: a dense layer 0, then MoE layers of 8
# experts top-2 beside 2 shared ones, MLA at 4 heads of 16 + 8 against v 16
CFG = dict(
    name="moonlight-small",
    reference="mla_moe_lm", hidden_size=64, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=4, q_lora_rank=None,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
    first_k_dense_replace=1, n_group=1, topk_group=1,
    scoring_func="sigmoid", topk_method="noaux_tc", norm_topk_prob=True,
    routed_scaling_factor=2.446, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=50000.0, vocab_size=300, padded_vocab=512,
    capacity_multiple=4, dtype="float32")
SEED = 11


def _small(dtype="float32"):
    """(config dict, program config, LM loaded from the seed, fetch)."""
    cfg = dict(CFG, dtype=dtype)
    mc = Driver(cfg, {}, 0, CPU)._model_config()
    lm = LM(mc, device="cpu").eval()
    groups = mla_moe_lm.weight_groups(cfg)
    weights.fill_module(lm, groups, SEED)
    return cfg, mc, lm, lambda g: weights.draw_group(groups[g], SEED, g, CPU)


@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(1)
    return _small()


def _ids(n, seed=0, B=2):
    return np.random.default_rng(seed).integers(0, 300, (B, n))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_matches_the_reference_at_every_position(small, use_kernels):
    """Every position's logits, on the plain attention route and on the
    flash wrapper's (its plain version on the CPU, v at 16 against q·k at
    24), against the reference's whole forward."""
    cfg, mc, lm, fetch = small
    ids = _ids(13)
    with torch.no_grad():
        got = lm(torch.as_tensor(ids), Parallel(use_kernels=use_kernels))[0]
    want = mla_moe_lm.forward(cfg, fetch, ids)
    got = got[..., :300]
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_the_layers_know_their_index(small):
    _, mc, lm, _ = small
    assert lm.layers[0].mlp is not None and lm.layers[0].moe is None
    assert all(l.moe is not None and l.mlp is None and
               l.moe.shared is not None for l in lm.layers[1:])
    assert [l.kind for l in lm.layers] == ["mla"] * 3


def test_prefill_then_decode_through_the_latent_cache(small):
    """Prefill 7 positions, pad the latent caches as the engine does, then
    4 decode steps that read them in the absorbed form: each step's logits
    equal the reference's whole forward at that position."""
    cfg, mc, lm, fetch = small
    P, K = 7, 4
    ids = _ids(P + K, seed=1)
    eng = ServeEngine(mc, lm, max_len=P + K + 1, par=Parallel())
    with torch.no_grad():
        logits, _, caches = lm(torch.as_tensor(ids[:, :P]), Parallel(),
                               mode="prefill")
        assert all(isinstance(c, LatentCache) for c in caches)
        assert caches[0].c_kv.shape == (2, P, 32)
        assert caches[0].k_rope.shape == (2, P, 8)
        caches = eng._pad_caches(caches, 2, P)
        assert caches[0].c_kv.shape == (2, P + K + 1, 32)
        got = [logits[:, -1]]
        for j in range(K - 1):
            tok = torch.as_tensor(ids[:, P + j:P + j + 1])
            out, caches = lm.decode_step(tok, caches, P + j)
            got.append(out[:, 0])
    want = mla_moe_lm.forward(cfg, fetch, ids)
    for j, g in enumerate(got):
        w = want[:, P - 1 + j]
        assert float((g[:, :300] - w).abs().max()) < \
            1e-4 * float(w.abs().max()), j


def test_decode_never_expands_the_cache(small):
    """Decode reads the latent cache in place: wkv_b (the expansion) is
    never applied to it, only folded into q and the output."""
    _, mc, lm, _ = small
    calls = []
    hooks = [layer.mixer.wkv_b.register_forward_hook(
        lambda m, a, o: calls.append(a[0].shape)) for layer in lm.layers]
    ids = torch.as_tensor(_ids(5, seed=2))
    try:
        with torch.no_grad():
            caches = lm.init_caches(2, 8)
            lm.decode_step(ids[:, :1], caches, 0)
            assert calls == []
            lm(ids, Parallel(), mode="prefill")
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == 3


def test_serve_engine_spans_and_cache_bytes(small):
    cfg, mc, lm, _ = small
    tr = Tracer()
    eng = ServeEngine(mc, lm, max_len=12, par=Parallel(), tracer=tr)
    ids = _ids(6, seed=3)
    rids = [eng.submit(p, max_new=3) for p in ids]
    out = eng.run()
    assert [len(out[r]) for r in rids] == [3, 3]
    names = [s.name for s in tr.spans]
    for n in ("mla", "mla.latent", "mla.decode", "flash_attention",
              "moe.shared", "moe.route"):
        assert n in names, n
    pad = next(s for s in tr.spans if s.name == "serve.pad_caches")
    # 3 layers, 2 rows, 12 positions of 32 latent and 8 rope values, fp32
    assert pad.attrs["cache_bytes"] == 3 * 2 * 12 * (32 + 8) * 4
    fa = next(s for s in tr.spans if s.name == "flash_attention")
    assert (fa.attrs["hd"], fa.attrs["hd_v"]) == (24, 16)
    assert {s.attrs["scoring"] for s in tr.spans
            if s.name == "moe.route"} == {"sigmoid"}


def test_sigmoid_routing_ties_bias_and_scale():
    """Ties go to the lower index; the bias selects but does not weight;
    the gates are the chosen scores over their sum, times the scale."""
    m = tmoe.MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)
    # logits: token 0 ties experts 1 and 2 (and 3), token 1 does not
    w = torch.eye(4)
    x = torch.tensor([[0.0, 1.0, 1.0, 1.0], [3.0, 2.0, 1.0, 0.0]])
    bias = torch.zeros(4)
    gates, idx, _ = tmoe.route(w, x, m, scoring="sigmoid", bias=bias,
                               scale=2.5)
    assert idx.tolist() == [[1, 2], [0, 1]]
    s = torch.sigmoid(x)
    assert torch.allclose(gates[1], 2.5 * s[1, :2] / s[1, :2].sum())
    assert torch.allclose(gates[0], torch.tensor([1.25, 1.25]))
    # a bias on expert 3 moves it into token 1's choice, weighted by its
    # own score alone
    bias = torch.tensor([0.0, 0.0, 0.0, 0.9])
    gates, idx, _ = tmoe.route(w, x, m, scoring="sigmoid", bias=bias,
                               scale=2.5)
    assert idx.tolist() == [[3, 1], [3, 0]]
    want = 2.5 * torch.stack([s[1, 3], s[1, 0]]) / (s[1, 0] + s[1, 3])
    assert torch.allclose(gates[1], want)


def test_sigmoid_routing_takes_fp32_logits_of_bf16_inputs():
    m = tmoe.MoEConfig(num_experts=8, top_k=2, d_ff_expert=8)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 16, generator=g).bfloat16()
    w = torch.randn(16, 8, generator=g).bfloat16()
    bias = torch.randn(8, generator=g) * 0.05
    gates, idx, _ = tmoe.route(w, x, m, scoring="sigmoid", bias=bias)
    s = torch.sigmoid(x.float() @ w.float())
    want = torch.sort(s + bias, dim=-1, descending=True, stable=True).indices
    assert torch.equal(idx, want[:, :2]) and gates.dtype == torch.float32


def test_softmax_route_is_unchanged_on_olmoe():
    """The softmax route, bit for bit as before the sigmoid one: bf16
    logits, softmax in fp32, the lower-index-first top-k, renormalised."""
    cfg = smoke_config(get_config("olmoe-1b-7b"))
    lm = init_lm(prng.PRNGKey(3), cfg, device="cpu",
                 param_dtype=torch.bfloat16)
    moe = lm.layers[0].moe
    assert moe.router_bias is None and moe.shared is None
    assert moe.routing() == {}
    x = torch.randn(64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    gates, idx, aux = tmoe.route(moe.w_router, x, cfg.moe)
    probs = torch.softmax((x @ moe.w_router).float(), -1)
    g, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, i = g[:, :cfg.moe.top_k], i[:, :cfg.moe.top_k]
    assert torch.equal(idx, i) and torch.equal(gates, g / g.sum(-1, True))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wrapper_plain_route_takes_a_narrower_v(causal):
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(2, 9, 4, 24, generator=g) for _ in "qk")
    v = torch.randn(2, 9, 4, 16, generator=g)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    assert out.shape == (2, 9, 4, 16)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 24 ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert float((out - want).abs().max()) < 1e-5
    ref = fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal)
    assert torch.equal(ref.transpose(1, 2), out)


def test_registered_config_counts_the_published_size():
    """moonlight-16b-a3b at full width, allocated on the meta device: its
    parameters (less norms and selection biases) are the config's count,
    15.96 B, 2.91 B of them active a token."""
    mc = get_config("moonlight-16b-a3b")
    lm = LM(mc, device="meta")
    n = sum(p.numel() for name, p in lm.named_parameters()
            if not name.endswith(("scale", "router_bias")))
    assert n == mc.param_counts()["total"] == 15_959_982_080
    assert mc.param_counts()["active"] == 2_914_648_064
    assert [mc.moe_layer(i) for i in range(3)] == [False, True, True]
    assert [layer.moe is not None for layer in lm.layers[:3]] == [
        False, True, True]
    assert dataclasses.asdict(mc.moe) == {
        "num_experts": 64, "top_k": 6, "d_ff_expert": 1408, "every_n": 1,
        "moe_offset": 0, "capacity_factor": 1.25, "router_aux_weight": 0.01}
    with pytest.raises(NotImplementedError):
        init_lm(prng.PRNGKey(0), mc, device="meta")


def test_moe_ep_routes_by_sigmoid_and_adds_the_shared_experts_once(small):
    """The expert-parallel path on a 1 × 1 CPU mesh against ``moe_dense``:
    the same selection bias and scale, the shared experts added once
    (capacity ample on both paths, so no pair drops)."""
    from repro_torch.launch.mesh import make_host_mesh
    _, mc, lm, _ = small
    cfg = dataclasses.replace(mc, moe=dataclasses.replace(
        mc.moe, capacity_factor=8.0))
    moe = lm.layers[1].moe
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(5))
    par = Parallel(model_axis="model", data_axes=("data",),
                   mesh=make_host_mesh(1, 1, device="cpu"))
    with torch.no_grad():
        want, _ = tmoe.moe_dense(moe, cfg, x)
        got, _ = tmoe.moe_ep(moe, cfg, x, par)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
