"""Sharded-pipeline overhead (BASELINE.json:10): time
compress_sharded/decompress_sharded on a 1-device mesh vs the unsharded
api path on the same corpus. The delta bounds the
shard_map/collective/gather orchestration cost.

    python bench/shard_overhead.py [MB]

One JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    n_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    import bench as bench_mod
    import jax

    from mhc import api
    from mhc.parallel import mesh as meshmod, pipeline

    data = bench_mod.make_corpus(n_mb << 20)
    res = {"mb": n_mb, "platform": jax.default_backend(),
           "devices": len(jax.devices())}
    m = meshmod.make_mesh(1)

    def timed(name, fn, reps=2):
        out = fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        res[name] = round(best, 4)
        print(f"[shard] {name}: {best:.4f}s", flush=True)
        return out

    blob_u = timed("unsharded_compress_s", lambda: api.compress(
        data, mode="markov"))
    blob_s = timed("sharded_compress_s", lambda: pipeline.compress_sharded(
        data, m, mode="markov"))
    assert blob_s == blob_u, "sharded container differs"
    out_u = timed("unsharded_decompress_s", lambda: api.decompress(blob_u))
    out_s = timed("sharded_decompress_s",
                  lambda: pipeline.decompress_sharded(blob_s, m))
    assert out_u == data and out_s == data
    res["compress_overhead_x"] = round(
        res["sharded_compress_s"] / res["unsharded_compress_s"], 3)
    res["decompress_overhead_x"] = round(
        res["sharded_decompress_s"] / res["unsharded_decompress_s"], 3)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
