"""Fixed-cost diet probe for the 1 MB BASELINE configs (VERDICT r4 #5).

    python bench/small_input.py [MB]

At 1 MB the fixed costs (host syncs, dispatches) weigh against a C++
oracle that finishes the whole job in ~22 ms. This probe times the
device-resident engine encode/decode walls at small input under (a) the
host C++ table build (one counts fetch sync) vs (b) the on-device
builder (no mid-encode sync), and reports the measured host-sync floor
alongside. Refuses to run without a GPU. One JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    n_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 1
    import bench as bench_mod
    import jax
    import jax.numpy as jnp
    from mhc import engine
    from mhc.utils import device

    n = int(n_mb * (1 << 20))
    res = {"mb": n_mb, "device": device.require_gpu(),
           "card": device.card()}
    data = bench_mod.make_corpus(n)

    # measured host-sync floor: time a trivial scalar fetch
    x = jnp.ones((8, 8))
    for _ in range(2):
        float(jnp.sum(x))
    t0 = time.perf_counter()
    float(jnp.sum(x))
    res["sync_floor_s"] = round(time.perf_counter() - t0, 4)

    for mode in ("markov", "huffman"):
        st = engine.stage(data, mode=mode)
        for build in ("host", "device"):
            os.environ["MHC_TABLE_BUILD"] = build
            te = td = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                enc = engine.encode(st)
                jax.block_until_ready(enc.payload)
                te = min(te, time.perf_counter() - t0)
            for _ in range(3):
                t0 = time.perf_counter()
                outs = jax.block_until_ready(engine.decode(enc))
                td = min(td, time.perf_counter() - t0)
            got = engine.fetch_bytes(enc, outs)
            if got != data:
                import numpy as _np
                a = _np.frombuffer(got, _np.uint8)
                d0 = _np.frombuffer(data, _np.uint8)
                diff = _np.where(a[: len(d0)] != d0[: len(a)])[0]
                raise AssertionError(
                    f"roundtrip mismatch {mode}/{build}: len {len(got)} vs "
                    f"{len(data)}, first diff "
                    f"{diff[0] if len(diff) else 'len-only'}, ndiff "
                    f"{len(diff)}, unit "
                    f"{diff[0] // st.decode_unit if len(diff) else '-'}")
            row = {"enc_s": round(te, 4), "dec_s": round(td, 4),
                   "enc_GBps": round(n / te / 1e9, 4),
                   "dec_GBps": round(n / td / 1e9, 4)}
            res[f"{mode}_{build}"] = row
            print(f"[small] {mode} build={build}: enc {te*1e3:.1f} ms "
                  f"dec {td*1e3:.1f} ms", flush=True)
    os.environ.pop("MHC_TABLE_BUILD", None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
