"""The port's ragged tables follow the reference's EAGER respacing.

The reference builds a ragged wave's per-row tables from ``respaced_ts``
called eagerly (``guidance._respaced_ts_host``), while its jitted
``sample_cfg`` traces the same function inside a jit.  XLA rounds the
float32 linspace differently in the two, so the trajectories differ at
54 of the 1000 step counts at T = 1000 (ROADMAP, queue 3).  An eager
call costs about half a second of compiles, so the tables are held
exactly against the reference's at the 54 divergent step counts and 50
others, not at all 1000.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import guidance as jguid
from repro.diffusion import schedule as jsched
from repro_torch.diffusion import guidance as tguid
from repro_torch.diffusion import schedule as tsched
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

T = 1000


def _divergent():
    """Step counts where the port's eager and jitted trajectories differ."""
    return [k for k in range(1, T + 1)
            if not np.array_equal(tguid.respaced_ts(T, k).numpy(),
                                  tguid.respaced_ts(T, k, eager=True).numpy())]


def test_eager_and_sampler_trajectories_differ_at_54_step_counts():
    div = _divergent()
    assert len(div) == 54
    assert {19, 27, 29, 31, 37, 541, 703, 815} <= set(div)
    assert 50 not in div


@pytest.mark.parametrize("num", [2, 16, 17, 19, 100, 351, 352, 353, 354,
                                 384, 385, 541, 703, 815, 999, 1000])
def test_eager_linspace_floats_equal_reference(num):
    """An eager ``jnp.linspace`` fuses ``1 - i/div`` into one rounding only
    in whole 32-lane chunks, and only from 353 elements on."""
    ref = np.asarray(jnp.linspace(T - 1, 0, num))
    port = tguid._reference_linspace(T - 1, num, tguid._EAGER_FUSION)
    assert port.dtype == np.float32 and np.array_equal(port, ref)


def test_ragged_tables_equal_reference_on_the_eager_trajectory():
    div = _divergent()
    rest = [k for k in range(1, T + 1) if k not in div]
    others = rest[::len(rest) // 50][:50]
    steps = np.array(div + others, np.int32)
    ref_sched = jsched.make_schedule(T)
    port_sched = tsched.NoiseSchedule(*(torch.tensor(np.asarray(a))
                                        for a in ref_sched))
    ref = jguid.ragged_tables(ref_sched, steps, T)
    port = tguid.ragged_tables(port_sched, steps, T)
    for name, r, p in zip(("ts", "ab_t", "ab_prev", "jloc"), ref, port):
        assert p.dtype == r.dtype and p.shape == (len(steps), T), name
        assert np.array_equal(p, r), name
    # the tables are right-aligned: the last k columns of row b are its
    # own k-step trajectory, which is the reference's eager one
    for b in (0, 1, len(div)):
        k = steps[b]
        assert np.array_equal(port[0][b, T - k:],
                              np.asarray(jguid.respaced_ts(T, int(k))))
    with pytest.raises(ValueError):
        tguid.ragged_tables(port_sched, [3, 9], 8)
