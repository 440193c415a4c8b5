"""The port's MoE FFN (``models/moe.py``) and the two MoE configs
(olmoe-1b-7b, phi3.5-moe) against the JAX package's, on the CPU.

Sizes are the configs' ``smoke_config`` (2 layers, d 256, 4 heads of 64,
4 experts top-2, expert d_ff 512), or that config with 16 experts where an
expert must drop tokens.  Parameters cross over as numpy.

Tolerances: 2e-5 in fp32 (relative to the output's size where the expert
sums grow it), the gate ``test_torch_lm.py`` holds the LM to: what differs
is the order of fp32 sums.  In bf16 each expert GEMM and each combine add
rounds to bf16, and the two packages sum in another order, so the output
is held at two bf16 ulps of its largest value (2^-6 of it); the experts
chosen must be the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models import moe as jmoe
from repro.models import transformer as jlm
from repro.models.attention import KVCache as JKVCache
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.convert import lm_state_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tlm
from test_torch_init import assert_states_within_rounding
from test_torch_lm import _err, _tokens, lm_pair
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 2e-5
MOE_CONFIGS = {"olmoe": "olmoe-1b-7b", "phi35_moe": "phi3.5-moe-42b-a6.6b"}


def cfg_pair(name: str = "olmoe-1b-7b", **moe):
    """(reference, port) smoke configs, the MoE sub-config's fields
    replaced by ``moe``."""
    j = jshapes.smoke_config(jget_config(name))
    t = tshapes.smoke_config(get_config(name))
    return (j.replace(moe=dataclasses.replace(j.moe, **moe)),
            t.replace(moe=dataclasses.replace(t.moe, **moe)))


def port_moe(params, cfg, dtype=torch.float32):
    mod = tmoe.MoE(cfg, device="cpu", dtype=dtype)
    mod.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                         for k, v in params.items()})
    return mod


# --- init ---------------------------------------------------------------------

def test_init_moe_matches_the_reference_draw():
    """The port's ``init_moe`` tree from the same key, within a few ulps
    (``test_torch_init.py``), and the reference's fan-in quirk kept:
    ``lecun_init`` takes axis 0, so the (E, d, fe) experts are drawn at
    std 1/√E (here 1/2, not 1/√d = 1/16); the down experts at 1/√fe."""
    jcfg, tcfg = cfg_pair()
    key = jax.random.PRNGKey(5)
    want = jmoe.init_moe(key, jcfg)
    got = tlm._drawn(tlm._moe_tree(np.asarray(key)[None], tcfg, "cpu"))
    assert sorted(got) == sorted(want) == ["experts_down", "experts_gate",
                                           "experts_up", "w_router"]
    assert_states_within_rounding(
        {k: torch.tensor(np.asarray(v)) for k, v in want.items()},
        {k: v[0] for k, v in got.items()})
    E, d, fe = 4, 256, 512
    for name, fan_in in (("experts_up", E), ("experts_gate", E),
                         ("experts_down", fe), ("w_router", d)):
        bound = float(got[name].abs().max()) * np.sqrt(fan_in)
        assert 1.9 < bound <= 2.0, (name, bound)   # truncated at 2 std


@pytest.mark.parametrize("variant", list(MOE_CONFIGS))
def test_init_lm_matches_the_reference(variant):
    """``init_lm`` of the MoE smoke configs against the reference's
    ``init_lm`` tree through ``lm_state_from_jax``; and that converter on
    the port's own ``init_lm_tree`` gives the same state bit for bit, its
    expert leaves in the reference's (E, in, out) layout."""
    jcfg, tcfg = cfg_pair(MOE_CONFIGS[variant])
    key = jax.random.PRNGKey(13)
    ref = jax.jit(jlm.init_lm, static_argnums=1)(key, jcfg)
    want = lm_state_from_jax(jax.tree.map(np.asarray, ref), tcfg)
    lm = tlm.init_lm(np.asarray(key), tcfg, device="cpu")
    state = lm.state_dict()
    assert_states_within_rounding(want, state)
    mine = lm_state_from_jax(tlm.init_lm_tree(np.asarray(key), tcfg, "cpu"),
                             tcfg)
    assert sorted(mine) == sorted(state)
    assert all(torch.equal(mine[k], v) for k, v in state.items())
    m = tcfg.moe
    assert state["layers.1.moe.experts_up"].shape == (
        m.num_experts, tcfg.d_model, m.d_ff_expert)
    assert state["layers.1.moe.experts_down"].shape == (
        m.num_experts, m.d_ff_expert, tcfg.d_model)
    assert state["layers.1.moe.w_router"].shape == (tcfg.d_model,
                                                    m.num_experts)
    assert not any(k.startswith("layers.0.mlp") for k in state)


# --- routing ------------------------------------------------------------------

def test_route_matches_the_reference_in_fp32():
    jcfg, tcfg = cfg_pair(num_experts=8)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (0.1 * rng.standard_normal((256, 8))).astype(np.float32)
    gates, idx, aux = jmoe._route(jnp.asarray(w), jnp.asarray(x), jcfg.moe)
    tg, ti, ta = tmoe.route(torch.from_numpy(w), torch.from_numpy(x),
                            tcfg.moe)
    assert np.array_equal(ti.numpy(), np.asarray(idx))
    assert _err(tg, gates) < 1e-6
    assert abs(float(ta) - float(aux)) < 1e-6 and float(aux) >= 1.0 - 1e-6


def tie_case(T: int = 48, d: int = 64):
    """bf16 inputs whose router logits tie at the top-2 boundary on every
    token: expert 0's column is 3u, experts 3, 5 and 6 share the column 2u,
    the others smaller multiples of u, with x·u > 0, so the second choice
    is a three-way tie that ``jax.lax.top_k`` breaks to expert 3."""
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((T, d))).astype(np.float32)
    u = np.abs(rng.standard_normal(d)).astype(np.float32) / d
    mult = np.array([3, 1, 0.5, 2, -1, 2, 2, 1.5], np.float32)
    return x, (u[:, None] * mult[None]).astype(np.float32)


def test_route_in_bf16_breaks_ties_as_the_reference():
    jcfg, tcfg = cfg_pair(num_experts=8)
    x, w = tie_case()
    gates, idx, aux = jmoe._route(jnp.asarray(w),
                                  jnp.asarray(x).astype(jnp.bfloat16),
                                  jcfg.moe)
    xb = torch.from_numpy(x).bfloat16()
    logits = (xb @ torch.from_numpy(w).bfloat16()).float()
    assert torch.equal(logits[:, 3], logits[:, 5])   # the ties are real
    assert torch.equal(logits[:, 3], logits[:, 6])
    tg, ti, ta = tmoe.route(torch.from_numpy(w), xb, tcfg.moe)
    assert np.array_equal(np.asarray(idx)[:, 1], np.full(len(x), 3))
    assert np.array_equal(ti.numpy(), np.asarray(idx))
    assert _err(tg, gates) < 1e-6 and abs(float(ta) - float(aux)) < 1e-6
    # the lower index first among equal values, past the k boundary too
    vals, order = tmoe.top_k_lower_first(logits, 8)
    assert order[:, :4].tolist() == [[0, 3, 5, 6]] * len(x)


def test_capacity_drops_the_tokens_the_reference_drops():
    """16 experts top-2 over 32 tokens: capacity cdiv(64, 16)·4 = 16 rows,
    and a router that sends every token to experts 0 and 1 first, so each
    keeps its first 16 tokens in token order and drops the other 16, as
    ``jnp.nonzero(size=capacity, fill_value=T)`` does.  The output holds
    only the kept tokens' rows."""
    jcfg, tcfg = cfg_pair(num_experts=16)
    T, d = 32, 256
    cap = tmoe.capacity(T, tcfg.moe)
    assert cap == 16
    params = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    x = (np.abs(rng.standard_normal((2, 16, d))) + 0.5).astype(np.float32)
    w = np.asarray(params["w_router"]).copy()
    w[:, 0] += 0.5
    w[:, 1] += 0.3
    params = {**params, "w_router": jnp.asarray(w)}
    flat = jnp.asarray(x.reshape(T, d))
    gates, idx, _ = jmoe._route(params["w_router"], flat, jcfg.moe)
    tg, ti, _ = tmoe.route(torch.from_numpy(w), torch.from_numpy(
        x.reshape(T, d)), tcfg.moe)
    tok, wgt, slot = tmoe.dispatch(tg, ti, 16, cap)
    for e in range(16):
        w_t = jnp.sum(jnp.where(idx == e, gates, 0.0), axis=-1)
        want = np.asarray(jnp.nonzero(w_t > 0, size=cap, fill_value=T)[0])
        assert np.array_equal(tok[e].numpy(), want), e
    assert (np.asarray(idx)[:, :2] == [0, 1]).all()
    assert tok[0].tolist() == list(range(16)) == tok[1].tolist()
    assert int((slot < 16 * cap).sum()) == 2 * cap    # 32 of 64 pairs kept
    want, jaux = jmoe.moe_dense(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tmoe.moe_apply(port_moe(params, tcfg), tcfg,
                                  torch.from_numpy(x))
    assert _err(got, want) < TOL * max(1.0, float(jnp.max(jnp.abs(want))))
    assert abs(float(aux) - float(jaux)) < 1e-5
    # the last 16 tokens lost both experts: their rows are exactly 0
    assert not got[1].any() and got[0].abs().amax(-1).gt(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_matches_the_reference(dtype):
    jcfg, tcfg = cfg_pair()
    params = jmoe.init_moe(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(1).standard_normal((2, 16, 256)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want, jaux = jmoe.moe_dense(params, jcfg, jx)
    mod = port_moe(params, tcfg, getattr(torch, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        got, aux = tmoe.moe_apply(mod, tcfg, tx)
        _, ti, _ = tmoe.route(mod.w_router, tx.reshape(-1, 256), tcfg.moe)
    _, idx, _ = jmoe._route(params["w_router"], jx.reshape(-1, 256),
                            jcfg.moe)
    assert np.array_equal(ti.numpy(), np.asarray(idx))
    assert got.dtype == tx.dtype
    scale = float(jnp.max(jnp.abs(want.astype(jnp.float32))))
    tol = TOL * max(scale, 1.0) if dtype == "float32" else 2.0 ** -6 * scale
    assert _err(got.float(), want.astype(jnp.float32)) <= tol
    assert abs(float(aux) - float(jaux)) < 1e-5


# --- the MoE LMs --------------------------------------------------------------

@pytest.fixture(scope="module", params=list(MOE_CONFIGS))
def pair(request):
    return lm_pair(request.param, seed=2)


def test_forward_logits_and_aux_match_the_reference(pair):
    jcfg, tcfg, jp, lm = pair
    toks = _tokens(10)
    want, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = lm(torch.from_numpy(toks))
    assert float(jnp.max(jnp.abs(want))) > 1e-1
    assert _err(got, want) < TOL
    # two layers' Switch losses, each ≥ 1
    assert float(jaux) >= 2.0 - 1e-5 and abs(float(aux) - float(jaux)) < 1e-5


def test_prefill_then_decode_matches_the_reference(pair):
    """Prefill 16 tokens (logits, aux and caches against the reference's
    prefill), pad the caches to 19 and decode 3 more against the
    reference's ``decode_step`` on the same caches (2e-5) and the full
    forward (5e-4, the reference's own prefill-vs-decode gate).  Decode
    routes B = 2 tokens a step: capacity cdiv(2·2, 4)·4 = 4."""
    jcfg, tcfg, jp, lm = pair
    toks = _tokens(11, L=19)
    P, K = 16, 3
    want, jaux, jcaches = jax.jit(lambda p, t: jlm.forward(
        p, jcfg, {"tokens": t}, mode="prefill"))(jp, jnp.asarray(toks[:, :P]))
    with torch.no_grad():
        full, _ = lm(torch.from_numpy(toks))
        lp, aux, caches = lm(torch.from_numpy(toks[:, :P]), mode="prefill")
    assert _err(lp, want) < TOL and abs(float(aux) - float(jaux)) < 1e-5
    for i, c in enumerate(caches):
        assert _err(c.k, jcaches["p0"].k[i]) < TOL
        assert _err(c.v, jcaches["p0"].v[i]) < TOL
    padded = lm.init_caches(2, P + K)
    for dst, src in zip(padded, caches):
        dst.k[:, :P], dst.v[:, :P] = src.k, src.v
    jc = {"p0": JKVCache(jnp.asarray(np.stack([c.k.numpy() for c in padded])),
                         jnp.asarray(np.stack([c.v.numpy() for c in padded])))}
    step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, jcfg, t, c, i))
    assert tmoe.capacity(2, tcfg.moe) == 4
    for i in range(K):
        t = toks[:, P + i:P + i + 1]
        with torch.no_grad():
            lg, padded = lm.decode_step(torch.from_numpy(t), padded, P + i)
        jlg, jc = step(jp, jnp.asarray(t), jc, jnp.int32(P + i))
        assert _err(lg, jlg) < TOL
        assert _err(lg[:, 0], full[:, P + i]) < 5e-4


# --- the compact expert pass (compact_dispatch, kernels/moe/ref.py) -------------

from repro_torch.kernels.moe import ref as moe_ref  # noqa: E402

#: (T, E, k, cap, D, e_start, E_loc, skew): plain; heavy drops; D shards;
#: shards over a slab of experts; a slab below E; most experts empty
COMPACT_CASES = {
    "plain": (64, 8, 2, 16, 1, 0, 8, 0.0),
    "heavy_drops": (48, 16, 3, 2, 1, 0, 16, 3.0),
    "shards": (40, 8, 2, 10, 3, 0, 8, 1.0),
    "shards_slab": (40, 8, 2, 10, 2, 4, 4, 1.0),
    "slab": (64, 16, 2, 5, 1, 6, 5, 0.0),
    "empty_experts": (16, 32, 1, 4, 1, 0, 32, 0.0),
    "tile_edges": (300, 2, 1, 260, 1, 0, 2, 0.3),
}


def routed(T, E, k, D, skew, seed=0):
    """(gates, idx) of D shards of T tokens, top-k of softmax logits with
    expert 0 leaning by ``skew``; every 7th token's last gate 0 (a pair
    the router names but the dispatch does not select)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((D, T, E), generator=g)
    logits[..., 0] += skew
    vals, idx = tmoe.top_k_lower_first(torch.softmax(logits, -1), k)
    gates = vals / vals.sum(-1, keepdim=True)
    gates[:, ::7, -1] = 0.0
    if D == 1:
        return gates[0], idx[0]
    return gates, idx


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_dispatch_keeps_the_padded_drop_set(case):
    """``compact_dispatch`` against ``dispatch``: the same kept (token,
    expert) pairs and drop set, each group's rows in token order at the
    padded path's ranks, the groups' tile offsets the kept rows rounded up
    to the 128-row tile (within the host's upper bound), and the span's
    counts."""
    T, E, k, cap, D, e0, El, skew = COMPACT_CASES[case]
    gates, idx = routed(T, E, k, D, skew)
    c = tmoe.compact_dispatch(gates, idx, E, cap, e0, El)
    tok, wgt, slot = tmoe.dispatch(gates, idx, E, cap, e0, El)
    n = tok.numel()
    BM = tmoe.BM
    # group (e, i) holds expert e's kept tokens of shard i, in token order
    kept_tok = tok.view(El, D, cap)
    ts = c.tile_start.tolist()
    for e in range(El):
        for i in range(D):
            g = e * D + i
            want = kept_tok[e, i][kept_tok[e, i] < D * T].tolist()
            lo, hi = ts[g] * BM, ts[g + 1] * BM
            got = c.rows[lo:hi].tolist()
            assert got[:len(want)] == want, (e, i)
            assert all(r == -1 for r in got[len(want):])
            assert ts[g + 1] - ts[g] == -(-len(want) // BM)
    assert ts[-1] <= c.tiles_max and c.rows.numel() == c.tiles_max * BM
    assert all(r == -1 for r in c.rows[ts[-1] * BM:].tolist())
    # each pair's compact row, in ascending expert order, against its slot
    ranked = torch.sort(idx.reshape(-1, k), dim=-1).values
    loc = ranked - e0
    here = (loc >= 0) & (loc < El)
    pslot = torch.where(here, slot.gather(1, loc.clamp(0, El - 1)), n)
    rows = c.pair_rows.long()
    assert torch.equal(rows >= 0, pslot < n)
    shard = torch.arange(D * T) // T
    for t, j in (rows >= 0).nonzero().tolist():
        e, s = int(loc[t, j]), int(pslot[t, j])
        g = e * D + int(shard[t])
        assert rows[t, j] - ts[g] * BM == s - e * D * cap - int(shard[t]) * cap
    chosen = (gates > 0).reshape(-1, k)
    here_pairs = ((idx >= e0) & (idx < e0 + El)).reshape(-1, k)
    assert int(c.counts()["dropped"]) == int((chosen & here_pairs).sum()
                                 - (slot < n).sum())
    assert int(c.counts()["pairs"]) == int(here_pairs.sum())
    assert int(c.counts()["expert_rows"]) == ts[-1] * BM
    if case == "heavy_drops":
        assert int(c.counts()["dropped"]) > T


@pytest.mark.parametrize("variant", ["gated", "non_gated", "shards_slab"])
def test_compact_pass_matches_the_padded_pass(variant):
    """``compact_pass`` (the plain versions on the CPU) against
    ``padded_pass`` in fp32 on one routing: within 2e-6 of the output's
    largest value (the same products, summed in another grouping of
    rows)."""
    cfg = tshapes.smoke_config(get_config("olmoe-1b-7b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8,
                                              top_k=3),
                      gated_mlp=variant != "non_gated",
                      mlp_act="gelu" if variant == "non_gated" else "silu")
    mod = tmoe.MoE(cfg)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / p.shape[-2] ** 0.5)
    D, e0, El, cap = ((3, 4, 4, 7) if variant == "shards_slab"
                      else (1, 0, 8, 20))
    T = 33
    x = torch.randn((D * T, cfg.d_model), generator=g)
    gates, idx, _ = tmoe.route(mod.w_router, x.view(D, T, -1)
                               if D > 1 else x, cfg.moe)
    with torch.no_grad():
        got = tmoe.compact_pass(mod, cfg, x, e0, El, cap, gates, idx)
        want = tmoe.padded_pass(mod, cfg, x, e0, El, cap, gates, idx)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert _err(got, want) <= 2e-6 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slab", [False, True])
def test_compact_combine_is_bit_equal_to_the_gather_add(dtype, slab):
    """Given the same expert rows, ``ref.combine`` on the compact layout
    and ``padded_combine`` on the padded one give the same bits: the same
    products, the same adds in ascending expert order, +0 for a dropped
    pair or an expert of another slab (rows holding -0 and values that
    cancel included)."""
    T, E, k, cap = 60, 8, 3, 12
    e0, El = (2, 4) if slab else (0, E)
    gates, idx = routed(T, E, k, 1, 1.5, seed=3)
    c = tmoe.compact_dispatch(gates, idx, E, cap, e0, El)
    tok, wgt, slot = tmoe.dispatch(gates, idx, E, cap, e0, El)
    dt = getattr(torch, dtype)
    d = 16
    y = torch.randn((c.tiles_max * tmoe.BM, d),
                    generator=torch.Generator().manual_seed(4)).to(dt)
    y[::5, ::3] = -0.0
    y[7] = -0.0
    # the padded buffer holds, at each kept pair's slot, the same row
    y_pad = torch.zeros((El, cap, d), dtype=dt)
    ts = c.tile_start.long()
    for t in range(T):
        for e in range(El):
            s = int(slot[t, e])
            if s < tok.numel():
                rank = s - e * cap
                y_pad[e, rank] = y[int(ts[e]) * tmoe.BM + rank]
    want = tmoe.padded_combine(y_pad, wgt, slot, idx, e0, E)
    got = moe_ref.combine(y, c.pair_rows, c.pair_gates)
    assert got.dtype == want.dtype == dt
    assert torch.equal(got.view(torch.int32 if dtype == "float32"
                                else torch.int16),
                       want.view(torch.int32 if dtype == "float32"
                                 else torch.int16))


def test_compact_pass_spans_say_what_they_compute():
    """The compact pass's spans on the CPU: ``moe.experts`` with path
    ``compact``, ``moe.dispatch`` with the kept rows rounded up to the
    tile as ``expert_rows`` and the drops; the padded pass's with path
    ``padded`` and E·cap rows."""
    from repro_torch.obs.trace import Tracer, resolve, using
    cfg = tshapes.smoke_config(get_config("olmoe-1b-7b"))
    mod = tmoe.MoE(cfg)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0, 0.05)
    x = torch.randn((40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5))
    gates, idx, _ = tmoe.route(mod.w_router, x, cfg.moe)
    tr = Tracer(enabled=True)
    with torch.no_grad(), using(tr):
        tmoe.compact_pass(mod, cfg, x, 0, 4, 12, gates, idx)
        tmoe.padded_pass(mod, cfg, x, 0, 4, 12, gates, idx)
    spans = [(s.name, resolve(s.attrs)) for s in tr.spans]
    paths = [a["path"] for n, a in spans if n == "moe.experts"]
    assert paths == ["compact", "padded"]
    (_, comp), (_, pad) = [(n, a) for n, a in spans if n == "moe.dispatch"]
    assert comp["pairs"] == pad["pairs"] == 80
    assert comp["dropped"] == pad["dropped"] > 0
    assert pad["expert_rows"] == 4 * 12
    # cap 12 < 128: one tile for each expert that selected a pair
    assert comp["expert_rows"] == 128 * len(set(idx[gates > 0].tolist()))
