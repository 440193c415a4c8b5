#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` and print the SHA-256 of every D_syn
that its ``SynthesisEngine.run`` calls return, so that two trees' runs can
be compared bit for bit:

    python3 tools/engine_digest.py path/to/checkout/chip_smoke.py

The checkout's own ``src`` is imported, so any version of the port and of
its smoke script can be run this way.  Each digest line reads
``engine_digest <n> rids <count> sha256 <hex>``: the n-th run's images,
rids in ascending order, as float32 bytes (copied to the host inside the
run, about 7 MB).

The client encodings are computed on the card as the script asks (their
digest is printed, ``engine_digest encodings ...``) and then again on the
host, and the script gets the host's: the card sums each category's
encodings with ``index_add_``, whose float atomics add in an order that
changes from process to process, so every D_syn conditioned on them would
differ between two runs of one tree in its last bits.  The smoke script's
exit code is this script's.
"""
from __future__ import annotations

import hashlib
import runpy
import sys
from pathlib import Path


def _sha(chunks) -> str:
    return hashlib.sha256(b"".join(chunks)).hexdigest()


def main() -> int:
    smoke = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(smoke.parent / "src"))
    from repro_torch.core import oscar
    from repro_torch.serve.synthesis import SynthesisEngine

    run, encodings, count = (SynthesisEngine.run, oscar.client_encodings,
                             [0])

    def digest_run(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        count[0] += 1
        sha = _sha(out[r].float().cpu().numpy().tobytes()
                   for r in sorted(out))
        print(f"engine_digest {count[0]} rids {len(out)} sha256 {sha}",
              flush=True)
        return out

    def host_encodings(fm, data, *, device=None):
        card = encodings(fm, data, device=device)
        host = encodings(fm, data, device="cpu")
        print(f"engine_digest encodings on {device} sha256 "
              f"{_sha([card[0].tobytes()])}, on the host sha256 "
              f"{_sha([host[0].tobytes()])}", flush=True)
        return host

    SynthesisEngine.run = digest_run
    oscar.client_encodings = host_encodings
    sys.argv = [str(smoke)]
    try:
        runpy.run_path(str(smoke), run_name="__main__")
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
