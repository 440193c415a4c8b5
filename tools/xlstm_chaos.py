#!/usr/bin/env python3
"""How far one fp32 ulp carries through xlstm-125m at full width, on the
CPU: the JAX reference (``repro.models``) and the port (``repro_torch``)
from the same weights, and each of them again with every weight moved by
one fp32 ulp (random signs from a numpy seed), over prompt lengths.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_chaos.py \
        [--lengths 16,64,128,512] [--seed 29]

The weights are the reference's ``init_lm`` draw from ``--seed`` in fp32
(the key ``chip_smoke.py`` phase 8h draws from).  For each length, one
JSON line: the largest last-position logit, how far the nudge moves the
reference's logits and the port's, and how far the port lies from the
reference.  If the first two grow to the logits' own size while the port
stays as far from the reference as a nudge moves either, the function
itself (not the port) carries roundings along the sequence.  Needs a few
GiB of host memory and no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="16,64,128,512")
    ap.add_argument("--seed", type=int, default=29)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget_config
    from repro.models.moe import Parallel as JParallel
    from repro.models.transformer import forward as jforward, init_lm
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_state_from_jax
    from repro_torch.models.moe import Parallel
    from repro_torch.models.transformer import LM

    jcfg = jget_config("xlstm-125m").replace(dtype="float32")
    tcfg = get_config("xlstm-125m").replace(dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(init_lm, static_argnums=1)(
        jax.random.PRNGKey(args.seed), jcfg))
    rng = np.random.default_rng(args.seed)
    nudged = jax.tree.map(lambda a: (a * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape))).astype(np.float32), params)
    lms = []
    for p in (params, nudged):
        lm = LM(tcfg, device="cpu")
        lm.load_state_dict(lm_state_from_jax(p, tcfg))
        lms.append(lm.eval())
    tokens = np.random.default_rng(args.seed).integers(
        0, tcfg.vocab_size, (1, max(map(int, args.lengths.split(","))))
    ).astype(np.int32)
    for L in map(int, args.lengths.split(",")):
        toks = tokens[:, :L]
        fn = jax.jit(lambda p: jforward(p, jcfg, {"tokens": jnp.asarray(toks)},
                                        JParallel(), mode="prefill")[0])
        ref = [np.asarray(fn(p))[0, -1] for p in (params, nudged)]
        with torch.no_grad():
            port = [m(torch.from_numpy(toks), Parallel(),
                      mode="prefill")[0][0, -1].numpy() for m in lms]
        err = lambda a, b: float(np.max(np.abs(a - b)))
        print(json.dumps({
            "model": "xlstm-125m", "dtype": "float32", "prompt": L,
            "max_abs_logit": float(np.max(np.abs(ref[0]))),
            "nudge_moves_reference": err(ref[1], ref[0]),
            "nudge_moves_port": err(port[1], port[0]),
            "port_vs_reference": err(port[0], ref[0]),
            "nudged_port_vs_nudged_reference": err(port[1], ref[1])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
