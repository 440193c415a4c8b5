"""The fused CFG update's keyed mode and its CUDA kernel's host side, on the
CPU.

The keyed plain versions (z = ``prng.normal`` of the step's threefry keys,
then the plain update) are held against the JAX package's ``cfg_update``,
``cfg_update_rowwise`` and ``cfg_update_mixed`` fed ``jax.random.normal``
noise from the same keys, as its oracle and as its Pallas kernel in
interpret mode.  The CUDA kernel's launch geometry (``kernel.geometry``,
``thread_items``) is replayed block by block, its route (``vector_route``)
checked, and the cached step scalars (``step_scalars``) are held against
the arithmetic of the rowwise kernel's table bit for bit.  No card and no
launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cfg_fuse import ops as j_cfg_ops
from repro.kernels.cfg_fuse import ref as j_cfg_ref
from repro_torch import prng
from repro_torch.diffusion.guidance import ancestral_coeffs, respaced_ts
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels.cfg_fuse import kernel as K
from repro_torch.kernels.cfg_fuse import ops as cfg_ops
from repro_torch.kernels.cfg_fuse import ref as cfg_ref
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


# --- the keyed plain versions against the reference -------------------------

@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 5, 7)])
@pytest.mark.parametrize("s,ab_t,ab_prev,t", [
    (2.0, 2.4288882e-09, 0.24600048, 999),     # first of 4 steps
    (7.5, 0.3, 0.6, 500),
    (2.0, 0.9, 1.0, 0),                        # the last step: no noise
])
def test_keyed_cfg_update_matches_reference(shape, s, ab_t, ab_prev, t):
    x, ec, eu = _normal(11, shape, shape, shape)
    jkey = jax.random.split(jax.random.PRNGKey(3))[1]
    noise = jax.random.normal(jkey, shape) * (t > 0)
    j = [jnp.asarray(a) for a in (x, ec, eu)]
    oracle = j_cfg_ref.cfg_update(*j, s, ab_t, ab_prev, noise)
    pallas = j_cfg_ops.cfg_update(*j, s, ab_t, ab_prev, noise,
                                  interpret=True)
    key = tuple(int(k) for k in np.asarray(jkey))
    before = cfg_ops.cfg_update.launches
    port = cfg_ops.cfg_update(*(torch.from_numpy(a) for a in (x, ec, eu)), s,
                              ab_t, ab_prev, None, noise_key=key,
                              live=t > 0)
    assert cfg_ops.cfg_update.launches == before      # the CPU launches none
    assert _max_err(port, oracle) < TOL
    assert _max_err(port, pallas) < TOL
    if t == 0:      # z = 0: the update is the noise-free one exactly
        assert torch.equal(port, cfg_ref.cfg_update(
            *(torch.from_numpy(a) for a in (x, ec, eu)), s, ab_t, ab_prev,
            torch.zeros(shape)))


def _keyed_rows(B, Bs, seed):
    """A keyed per-row call's operands: scalars (s, ᾱ_t, ᾱ_prev, active)
    over Bs slots with one row at the t = 999 first step, mid steps and
    frozen rows in turn; x, ε_c, ε_u (B, 8, 8, 3); and the noise of row
    b's key ``fold_in(row_keys[b], max(j, 0) + 1)`` times its live entry
    (t > 0; row 1 at its t = 0 step), once from ``jax.random`` and once
    as the port's key table and live vector."""
    table = [(2.0, 2.4288882e-09, 0.24600048, 1), (7.5, 0.3, 0.6, 1),
             (1.5, 0.9, 1.0, 1), (4.0, 0.05, 0.2, 0)]
    vecs = [np.array(c, np.float32) for c in zip(
        *(table[i % 4] for i in range(Bs)))]
    x, ec, eu = _normal(seed, *[(B, 8, 8, 3)] * 3)
    row_keys = jax.random.split(jax.random.PRNGKey(9), B)
    j_step = np.arange(B) % 3 - 1                 # a frozen row's j < 0
    t = np.where(np.arange(B) == 1, 0, 999)       # row 1 at its t = 0 step
    nk = jax.vmap(jax.random.fold_in)(row_keys, jnp.maximum(j_step, 0) + 1)
    noise = jax.vmap(lambda k: jax.random.normal(k, (8, 8, 3)))(nk)
    noise = noise * (t > 0)[:, None, None, None]
    keys = cfg_ops.key_table(prng.fold_in(np.asarray(row_keys),
                                          np.maximum(j_step, 0) + 1), "cpu")
    live = torch.as_tensor(t > 0).float()
    return vecs, (x, ec, eu), noise, keys, live


@pytest.mark.parametrize("B,Bs,off", [(5, 5, 0), (5, 9, 3), (4, 9, 0)])
def test_keyed_rowwise_update_matches_reference(B, Bs, off):
    """Row b's noise is drawn from its own key, ``fold_in(row_keys[b],
    max(j, 0) + 1)``, times its live entry (t > 0): one row at t = 0, one
    frozen, the rest at the t = 999 first step and at mid steps; the
    scalars span a wider wave at ``row_offset`` 3."""
    (s, ab_t, ab_prev, act), (x, ec, eu), noise, keys, live = _keyed_rows(
        B, Bs, 12)
    j = [jnp.asarray(a) for a in (x, ec, eu)]
    oracle = j_cfg_ref.cfg_update_rowwise_windowed(
        *j, s, ab_t, ab_prev, noise, act, row_offset=off)
    pallas = j_cfg_ops.cfg_update_rowwise(*j, s, ab_t, ab_prev, noise, act,
                                          row_offset=off, interpret=True)
    port = cfg_ops.cfg_update_rowwise(
        *(torch.from_numpy(a) for a in (x, ec, eu)), s, ab_t, ab_prev, None,
        act, row_offset=off, noise_keys=keys, live=live)
    assert _max_err(port, oracle) < TOL
    assert _max_err(port, pallas) < TOL
    frozen = act[off:off + B] == 0
    assert torch.equal(port[frozen], torch.from_numpy(x)[frozen])


def _modes(kind, Bs):
    """A mixed wave's mode row: all classifier-free, all classifier-guided,
    or classifier-guided every third slot from slot 1."""
    i = np.arange(Bs)
    return {"cfg": 0 * i, "clf": 0 * i + 1,
            "mixed": (i % 3 == 1) * 1}[kind].astype(np.float32)


@pytest.mark.parametrize("B,Bs,off", [(5, 5, 0), (5, 9, 3), (4, 9, 0)])
@pytest.mark.parametrize("kind", ["cfg", "clf", "mixed"])
def test_keyed_mixed_update_matches_reference(kind, B, Bs, off):
    """The mixed update with each row's noise drawn from its key, as the
    rowwise one: against the reference's oracle and Pallas kernel fed
    ``jax.random.normal`` of the same keys times live, for the three mode
    rows over windows of a wider wave; frozen rows unchanged and no
    launch counted on the CPU."""
    (s, ab_t, ab_prev, act), (x, ec, eu), noise, keys, live = _keyed_rows(
        B, Bs, 13)
    mode = _modes(kind, Bs)
    j = [jnp.asarray(a) for a in (x, ec, eu)]
    oracle = j_cfg_ref.cfg_update_mixed_windowed(
        *j, mode, s, ab_t, ab_prev, noise, act, row_offset=off)
    pallas = j_cfg_ops.cfg_update_mixed(*j, mode, s, ab_t, ab_prev, noise,
                                        act, row_offset=off, interpret=True)
    fn = cfg_ops.cfg_update_mixed
    before = (fn.launches, fn.launches_keyed)
    port = fn(*(torch.from_numpy(a) for a in (x, ec, eu)), mode, s, ab_t,
              ab_prev, None, act, row_offset=off, noise_keys=keys, live=live)
    assert (fn.launches, fn.launches_keyed) == before
    assert _max_err(port, oracle) < TOL
    assert _max_err(port, pallas) < TOL
    frozen = act[off:off + B] == 0
    assert torch.equal(port[frozen], torch.from_numpy(x)[frozen])


def test_keyed_plain_versions_are_the_draw_then_the_update():
    """The keyed forms add nothing to the update: bit-equal to drawing the
    noise with ``prng.normal`` and passing it in."""
    x, ec, eu = (torch.from_numpy(a) for a in _normal(13, *[(3, 4, 4, 3)] * 3))
    key = prng.split(prng.PRNGKey(1))[1]
    got = cfg_ops.cfg_update(x, ec, eu, 2.0, 0.3, 0.6, None,
                             noise_key=tuple(int(k) for k in key))
    assert torch.equal(got, cfg_ops.cfg_update(
        x, ec, eu, 2.0, 0.3, 0.6, prng.normal(key, x.shape)))
    keys = prng.split(prng.PRNGKey(2), 3)
    live = torch.tensor([1.0, 0.0, 1.0])
    vec = [np.full(3, v, np.float32) for v in (2.0, 0.3, 0.6, 1.0)]
    got = cfg_ops.cfg_update_rowwise(x, ec, eu, *vec[:3], None, vec[3],
                                     noise_keys=cfg_ops.key_table(keys, "cpu"),
                                     live=live)
    z = prng.normal(keys, (4, 4, 3)) * live[:, None, None, None]
    assert torch.equal(got, cfg_ops.cfg_update_rowwise(
        x, ec, eu, *vec[:3], z, vec[3]))


def test_keyed_wrappers_refuse_two_or_no_noise_sources():
    x = torch.zeros(2, 4)
    vec = np.ones(2, np.float32)
    with pytest.raises(ValueError):
        cfg_ops.cfg_update(x, x, x, 1.0, 0.3, 0.6, None)
    with pytest.raises(ValueError):
        cfg_ops.cfg_update(x, x, x, 1.0, 0.3, 0.6, x, noise_key=(0, 1))
    keys = cfg_ops.key_table(prng.split(prng.PRNGKey(0), 2), "cpu")
    with pytest.raises(ValueError):
        cfg_ops.cfg_update_rowwise(x, x, x, vec, vec, vec, None, vec,
                                   noise_keys=keys)     # no live vector
    with pytest.raises(ValueError):
        cfg_ops.cfg_update_rowwise(x, x, x, vec, vec, vec, x, vec,
                                   noise_keys=keys, live=torch.ones(2))
    for z, zk in ((None, {}), (x, dict(noise_keys=keys, live=torch.ones(2))),
                  (None, dict(noise_keys=keys))):     # the last: no live
        with pytest.raises(ValueError):
            cfg_ops.cfg_update_mixed(x, x, x, vec, vec, vec, vec, z, vec,
                                     **zk)


def test_key_table_holds_the_key_words():
    keys = prng.split(prng.PRNGKey(7), 6).reshape(2, 3, 2)
    table = cfg_ops.key_table(keys, "cpu")
    assert table.dtype == torch.int32 and tuple(table.shape) == (2, 3, 2)
    assert np.array_equal(table.numpy().view(np.uint32), keys)


# --- the cached step scalars -------------------------------------------------

@pytest.mark.parametrize("num_steps", [4, 50])
@pytest.mark.parametrize("s,eta", [(2.0, 1.0), (7.5, 1.0), (0.0, 0.0)])
def test_cached_step_scalars_equal_the_wave_table_bit_for_bit(num_steps, s,
                                                              eta):
    """Every step of a wave, as the sampler passes it (Python floats), gets
    the scalars of that step's column of ``rowwise_coeffs`` over the
    wave's vectors (1+s rounded once from the host number), and a second
    wave hits the cache with the same values."""
    sched = make_schedule(1000, device="cpu")
    ab_t, ab_prev = ancestral_coeffs(sched, respaced_ts(1000, num_steps))
    table = cfg_ops.rowwise_coeffs(s, ab_t.numpy(), ab_prev.numpy(), 1, eta)
    steps = list(zip(ab_t.tolist(), ab_prev.tolist()))
    first = [cfg_ops.step_scalars(s, abt, abp, eta) for abt, abp in steps]
    hits = cfg_ops.step_scalars.cache_info().hits
    again = [cfg_ops.step_scalars(s, abt, abp, eta) for abt, abp in steps]
    assert cfg_ops.step_scalars.cache_info().hits == hits + num_steps
    assert again == first
    for i, got in enumerate(first):
        assert all(type(v) is float for v in got)
        got = np.array(got, np.float32)
        assert got[0] == np.float32(1.0 + s)
        assert np.array_equal(got[1:].view(np.int32),
                              table[1:7, i].view(np.int32))


# --- the CUDA kernel's launch geometry --------------------------------------

def _replay(rows, n_row, vec, sms):
    """Every (row, element) the launch writes, with the run width it was
    written in, from ``thread_items`` over every block and thread."""
    blocks, threads = K.geometry(rows, n_row, vec, sms)
    assert 1 <= threads <= (K.MAX_THREADS if vec else K.ELEMENT_THREADS)
    assert threads % 32 == 0
    assert blocks <= sms * K.MAX_BLOCKS_PER_SM
    seen = np.zeros((rows, n_row), np.int64)
    widths = set()
    for b in range(blocks):
        for t in range(threads):
            for row, first, width in K.thread_items(b, t, blocks, threads,
                                                    rows, n_row, vec):
                seen[row, first:first + width] += 1
                widths.add(width)
                if width == 4:
                    assert first % 4 == 0
    return seen, widths, blocks, threads


@pytest.mark.parametrize("rows,n_row,vec", [
    (1, 128 * 768, True),            # a 128-row uniform wave, scalar variant
    (1, 120 * 768, True),
    (120, 768, True),                # a ragged wave, rowwise variant
    (60, 768, True),                 # a window
    (1, 105, False),                 # (3, 5, 7): one element at a time
    (5, 105 // 5, False),
    (3, 768, False),                 # an unaligned view of whole rows
    (400, 768, True),                # past one item a thread: the loop
    (120, 768, False),               # keyed: one element a thread
    (600, 768, False),               # keyed, past 8 blocks an SM
])
@pytest.mark.parametrize("sms", [132, 7])
def test_geometry_writes_every_element_once(rows, n_row, vec, sms):
    seen, widths, blocks, threads = _replay(rows, n_row, vec, sms)
    assert (seen == 1).all()
    assert widths == ({4} if vec else {1})


def test_geometry_at_the_main_path_fills_the_card():
    # z from memory: one block an SM at most, one 16-byte chunk a thread
    assert K.geometry(1, 128 * 768, True, 132) == (128, 192)
    assert K.geometry(120, 768, True, 132) == (120, 192)
    blocks, threads = K.geometry(400, 768, True, 132)
    assert threads == K.MAX_THREADS and blocks <= 132 * K.MAX_BLOCKS_PER_SM
    # z drawn from keys: one element a thread, blocks of 256
    assert K.geometry(1, 128 * 768, False, 132) == (384, 256)
    assert K.geometry(120, 768, False, 132) == (360, 256)
    assert K.geometry(1, 105, False, 132) == (1, 128)


def test_vector_route_only_where_whole_chunks_allow():
    x = torch.zeros(240, 16, 16, 3)
    eps2 = torch.zeros(240, 16, 16, 3)
    ptrs = [x.data_ptr(), eps2[:120].data_ptr(), eps2[120:].data_ptr()]
    assert K.vector_route(768, ptrs, False)            # eps2[B:] included
    assert not K.vector_route(105, [x.data_ptr()], False)   # odd total
    flat = torch.zeros(1000)
    assert not K.vector_route(768, [flat[1:].data_ptr()], False)  # 4 B off
    assert K.vector_route(768, [flat[4:].data_ptr()], False)
    assert not K.vector_route(768, ptrs + [flat[2:].data_ptr()], False)
    assert not K.vector_route(766, [x.data_ptr()], False)
    # z drawn from keys: one element a thread whatever the alignment
    assert not K.vector_route(768, ptrs, True)


@pytest.mark.parametrize("rows,n_row,vec,rowwise", [
    (1, 4 * 6 * 6 * 3, True, False), (1, 3 * 5 * 7, False, False),
    (4, 6 * 6 * 3, True, True), (3, 5 * 7, False, True),
    (4, 6 * 6 * 3, False, "mixed"), (3, 5 * 7, False, "mixed")])
def test_replayed_counters_and_keys_give_the_plain_draw(rows, n_row, vec,
                                                        rowwise):
    """Each element's noise rebuilt from the replay, as the kernel derives
    it: key = the step's (scalar variant) or the tensor row's (rowwise and
    mixed), counter = the element's index in that key's draw.  The result
    is the plain draw: ``prng.normal`` of the step key over the whole
    tensor, or of each row's key over the row.  A mixed window's rows take
    the keys of the tensor rows and the scalars of slots ``row_offset +
    b``: the update of the replayed noise is the keyed wrapper's, bit for
    bit."""
    step_key = prng.split(prng.PRNGKey(4))[1]
    row_keys = prng.split(prng.PRNGKey(5), rows)
    key_of = (lambda r: row_keys[r]) if rowwise else (lambda r: step_key)
    draws = {}
    z = np.full((rows, n_row), np.nan, np.float32)
    blocks, threads = K.geometry(rows, n_row, vec, 3)
    for b in range(blocks):
        for t in range(threads):
            for row, first, width in K.thread_items(b, t, blocks, threads,
                                                    rows, n_row, vec):
                key = tuple(key_of(row))
                if key not in draws:
                    draws[key] = prng.normal(np.array(key, np.uint32),
                                             (n_row,)).numpy()
                z[row, first:first + width] = draws[key][first:first + width]
    want = (prng.normal(row_keys, (n_row,)) if rowwise
            else prng.normal(step_key, (rows * n_row,)).reshape(rows, n_row))
    assert np.array_equal(z, want.numpy())
    if rowwise == "mixed":
        off, Bs = 2, rows + 3
        vecs = [np.linspace(a, b, Bs, dtype=np.float32) for a, b in
                ((1.0, 4.0), (0.05, 0.3), (0.2, 0.6), (1.0, 1.0))]
        mode = _modes("mixed", Bs)
        x, ec, eu = (torch.from_numpy(a) for a in _normal(15, *[(rows,
                                                                n_row)] * 3))
        live = torch.ones(rows)
        keyed = cfg_ops.cfg_update_mixed(
            x, ec, eu, mode, *vecs[:3], None, vecs[3], row_offset=off,
            noise_keys=cfg_ops.key_table(row_keys, "cpu"), live=live)
        assert torch.equal(keyed, cfg_ref.cfg_update_mixed_windowed(
            x, ec, eu, mode, *vecs[:3], torch.from_numpy(z), vecs[3], off))


def test_packed_arguments_match_the_kernel_source():
    # the source's static_assert: 8 pointers, 10 integers, 8 scalars and a
    # key of two words
    assert K._ARGS.size == 184
    src = K.SOURCE.read_text()
    assert "static_assert(sizeof(Args) == 184" in src
    # the variant field: _args packs 0, 1 or 2, and the source picks an
    # instance of each, in both noise modes
    assert "long long variant;       // 0 scalar, 1 rowwise, 2 mixed" in src
    for variant in (0, 1, 2):
        for keyed in ("true", "false"):
            assert f"cfg_kernel<{variant}, {keyed}>" in src
