"""Hybrid host/device executor END-TO-END sweep (VERDICT r4 #6).

    python bench/hybrid_e2e.py [MB]

The device-resident engine is the device-rate surface; the CONTAINER
path also crosses the host link. The hybrid executor (hybrid.py: C++
threads + device stream, byte-identical containers) splits units
between the two — this harness measures bytes->container->bytes wall
clock across MHC_HOST_FRACTION and prints the winner vs the oracle. One
JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    n_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    import bench as bench_mod
    from mhc import hybrid
    from mhc.utils import native

    data = bench_mod.make_corpus(n_mb << 20)
    n = len(data)
    res = {"mb": n_mb, "native": native.available()}
    oracle = bench_mod.oracle_baseline_bytes(data, "em") \
        if hasattr(bench_mod, "oracle_baseline_bytes") else None

    best = None
    for hf in (0.0, 0.5, 0.9, 1.0):
        te = td = float("inf")
        blob = None
        for _ in range(2):
            t0 = time.perf_counter()
            blob = hybrid.compress(data, mode="markov", host_fraction=hf)
            te = min(te, time.perf_counter() - t0)
        for _ in range(2):
            t0 = time.perf_counter()
            out = hybrid.decompress(blob, host_fraction=hf)
            td = min(td, time.perf_counter() - t0)
        assert out == data
        agg = 2 / (te / n + td / n) / 1e9
        row = {"enc_GBps": round(n / te / 1e9, 4),
               "dec_GBps": round(n / td / 1e9, 4),
               "agg_GBps": round(agg, 4), "bytes": len(blob)}
        res[f"hf_{hf}"] = row
        print(f"[hybrid] hf={hf}: enc {row['enc_GBps']} dec "
              f"{row['dec_GBps']} agg {row['agg_GBps']} GB/s "
              f"({len(blob)} B)", flush=True)
        if best is None or agg > best[1]:
            best = (hf, agg)
    res["best_hf"] = best[0]
    res["best_agg_GBps"] = round(best[1], 4)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
