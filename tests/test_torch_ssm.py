"""The port's recurrent mixers (``models/ssm.py``: Mamba; ``models/
xlstm.py``: mLSTM and sLSTM) against the JAX package's, on the CPU.

Sizes are the mixers' ``smoke_config`` (jamba-smoke: d 256, d_inner 512,
N 16, dt rank 16; xlstm-smoke: d 256, 4 heads, mLSTM d_inner 512, sLSTM
up-projection 341) at B = 2, S = 32.  The reference's init trees, every
leaf perturbed 0.05·normal from a numpy seed (so the zero conv biases and
the gate biases are exercised), cross over through ``convert.
lm_layer_items`` (bare leaves keep their names and layouts).  The chunked
forwards run at chunk 8, so the state is carried across three chunk
boundaries; at the LM's default chunks (128, 256) a 32-token test never
crosses one.

Tolerance: 2e-5 in fp32, the gate ``test_torch_lm.py`` holds the LM to:
the port runs the Mamba scan position by position where the reference
runs ``lax.associative_scan`` inside a chunk, and both sum in other orders
(a 0.9e-6 difference measured at a 256-token probe).  The port's own
chunked-vs-stepwise and chunk-size invariances are held at the reference's
own gates (``tests/test_ssm_blocks.py``).  bf16 is never gated against the
reference (XLA and torch round bf16 chains at different points); the port
in bf16 is held against itself in fp32 at a bf16 tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.convert import lm_layer_items
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.transformer import LM
from test_torch_lm import _err, perturbed
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 2e-5
B, S, CHUNK = 2, 32, 8
# kind -> (config, reference (init, forward, decode, init state), port
# (module, forward, decode, init state), chunked?)
MIXERS = {
    "mamba": ("jamba-1.5-large-398b",
              (jssm.init_mamba, jssm.mamba_forward, jssm.mamba_decode,
               jssm.init_mamba_state),
              (tssm.Mamba, tssm.mamba_forward, tssm.mamba_decode,
               tssm.init_mamba_state), True),
    "mlstm": ("xlstm-125m",
              (jxlstm.init_mlstm, jxlstm.mlstm_forward, jxlstm.mlstm_decode,
               jxlstm.init_mlstm_state),
              (txlstm.mLSTM, txlstm.mlstm_forward, txlstm.mlstm_decode,
               txlstm.init_mlstm_state), True),
    "slstm": ("xlstm-125m",
              (jxlstm.init_slstm, jxlstm.slstm_forward, jxlstm.slstm_decode,
               jxlstm.init_slstm_state),
              (txlstm.sLSTM, txlstm.slstm_forward, txlstm.slstm_decode,
               txlstm.init_slstm_state), False),
}


@functools.lru_cache(maxsize=None)
def mixer_pair(kind: str, seed: int = 0):
    """(jcfg, tcfg, reference params (jnp), port module on the CPU)."""
    name, (jinit, *_), (tmod, *_), _ = MIXERS[kind]
    jcfg = jshapes.smoke_config(jget_config(name))
    tcfg = tshapes.smoke_config(get_config(name))
    p = perturbed(jinit(jax.random.PRNGKey(seed), jcfg), seed + 1)
    mod = tmod(tcfg, device="cpu")
    mod.load_state_dict({k: load() for k, load in lm_layer_items("", p)})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), mod.eval()


def _x(seed, L=S, d=256):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, L, d))).astype(np.float32)


def _fwd_kw(kind, chunk):
    return {"chunk": chunk} if MIXERS[kind][3] else {}


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_forward_matches_reference(kind):
    jcfg, tcfg, jp, mod = mixer_pair(kind)
    jfwd, tfwd = MIXERS[kind][1][1], MIXERS[kind][2][1]
    x = _x(1)
    kw = _fwd_kw(kind, CHUNK)
    want = jax.jit(lambda p, v: jfwd(p, jcfg, v, **kw))(jp, jnp.asarray(x))
    with torch.no_grad():
        got = tfwd(mod, tcfg, torch.from_numpy(x), **kw)
    assert float(jnp.max(jnp.abs(want))) > 1e-1
    assert _err(got, want) < TOL


@pytest.mark.parametrize("kind", list(MIXERS))
def test_prefill_state_then_decode_matches_reference(kind):
    """The prefill's output and final state (``return_state=True``), then
    four decode steps from that state: each step's output and new state
    against the reference's on the same inputs and state."""
    jcfg, tcfg, jp, mod = mixer_pair(kind)
    _, jfwd, jdec, _ = MIXERS[kind][1]
    _, tfwd, tdec, _ = MIXERS[kind][2]
    x = _x(2, L=S + 4)
    kw = _fwd_kw(kind, CHUNK)
    want, jstate = jax.jit(lambda p, v: jfwd(p, jcfg, v, return_state=True,
                                             **kw))(jp, jnp.asarray(x[:, :S]))
    with torch.no_grad():
        got, state = tfwd(mod, tcfg, torch.from_numpy(x[:, :S]),
                          return_state=True, **kw)
    assert _err(got, want) < TOL
    assert type(state).__name__ == type(jstate).__name__
    for a, b in zip(state, jstate):
        assert a.shape == b.shape and _err(a, b) < TOL
    step = jax.jit(lambda p, v, s: jdec(p, jcfg, v, s))
    for t in range(S, S + 4):
        want, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        with torch.no_grad():
            got, state = tdec(mod, tcfg, torch.from_numpy(x[:, t:t + 1]),
                              state)
        assert float(jnp.max(jnp.abs(want))) > 1e-2
        assert _err(got, want) < TOL
        for a, b in zip(state, jstate):
            assert _err(a, b) < TOL


@pytest.mark.parametrize("kind", list(MIXERS))
def test_chunked_forward_matches_stepwise_decode_and_chunk_size(kind):
    """The port's chunked forward against its own decode run token by token
    from the initial state, and (for the chunked mixers) against itself at
    another chunk size, at the reference's gates for the same checks."""
    _, tcfg, _, mod = mixer_pair(kind)
    _, tfwd, tdec, tinit = MIXERS[kind][2]
    gate = 1e-4 if kind == "mamba" else 2e-4
    x = torch.from_numpy(_x(3))
    with torch.no_grad():
        full = tfwd(mod, tcfg, x, **_fwd_kw(kind, CHUNK))
        state, outs = tinit(tcfg, B, x.dtype, "cpu"), []
        for t in range(S):
            o, state = tdec(mod, tcfg, x[:, t:t + 1], state)
            outs.append(o)
        assert _err(full, torch.cat(outs, 1)) < gate
        if MIXERS[kind][3]:
            assert _err(full, tfwd(mod, tcfg, x, **_fwd_kw(kind, S))) < gate
            with pytest.raises(AssertionError, match="not divisible"):
                tfwd(mod, tcfg, x[:, :12], chunk=CHUNK)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_bf16_mixer_keeps_fp32_state_and_tracks_fp32(kind):
    """The mixer in bf16 (weights cast, fp32 parameters kept): a bf16
    output, the recurrent state in the reference's dtypes (fp32 but the
    conv window), and within bf16 rounding of the fp32 mixer."""
    _, tcfg, _, mod = mixer_pair(kind)
    _, tfwd, tdec, _ = MIXERS[kind][2]
    cfg16 = tcfg.replace(dtype="bfloat16")
    mod16 = MIXERS[kind][2][0](cfg16, device="cpu", dtype=torch.bfloat16)
    mod16.load_state_dict(mod.state_dict())
    x = torch.from_numpy(_x(4))
    with torch.no_grad():
        want = tfwd(mod, tcfg, x, **_fwd_kw(kind, CHUNK))
        got, state = tfwd(mod16, cfg16, x.bfloat16(), return_state=True,
                          **_fwd_kw(kind, CHUNK))
        o, state = tdec(mod16, cfg16, x[:, :1].bfloat16(), state)
    assert got.dtype == o.dtype == torch.bfloat16
    for name, t in state._asdict().items():
        assert t.dtype == (torch.bfloat16 if name == "conv"
                           else torch.float32), name
    scale = float(want.abs().max())
    assert _err(got.float(), want) < 2.0 ** -4 * scale


def test_bf16_lm_keeps_the_reference_fp32_parameters():
    """In a bf16 LM, the parameters the reference uses uncast (Mamba's
    ``A_log`` and ``D``, sLSTM's ``w_r`` and ``b``) and every norm scale are
    fp32; every other weight is bf16."""
    fp32 = ("A_log", "D", "w_r", "b", "scale")
    for name in ("jamba-1.5-large-398b", "xlstm-125m"):
        cfg = tshapes.smoke_config(get_config(name)).replace(
            dtype="bfloat16")
        kinds = set()
        for k, v in LM(cfg, device="meta").state_dict().items():
            leaf = k.rsplit(".", 1)[-1]
            want = torch.float32 if leaf in fp32 and (
                leaf != "b" or ".mixer.b" in k) else torch.bfloat16
            assert v.dtype == want, (k, v.dtype)
            kinds.add(leaf)
        assert {"A_log", "D"} <= kinds or {"w_r", "b"} <= kinds
