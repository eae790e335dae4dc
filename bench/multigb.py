"""Config-5 scale demonstration: multi-GB chained-segment roundtrip.

    python bench/multigb.py [GB] [segment_MB]

Streams a multi-GB corpus through compress_file / decompress_file with
segment chaining (each segment = one independent container: two-pass
histogram + table build + block-parallel encode), byte-compares the
roundtrip, and reports per-segment wall time and peak RSS — the memory
bound that makes the multi-GB case safe (SURVEY §7 phase 5 /
BASELINE config 5; the N>=2-host mechanics are exercised separately by
tests/test_multihost.py — this run demonstrates the at-scale segment
pipeline on one chip). One JSON line.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    n_gb = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    seg_mb = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    n_bytes = int(n_gb * (1 << 30))
    import bench as bench_mod

    work = os.path.join(REPO, ".cache", "bench")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, f"multigb_{n_gb}g.bin")
    if not (os.path.exists(src) and os.path.getsize(src) == n_bytes):
        with open(src, "wb") as f:
            written = 0
            piece = 256 << 20
            seed = 0
            while written < n_bytes:
                m = min(piece, n_bytes - written)
                f.write(bench_mod.make_corpus(m, seed=100 + seed))
                written += m
                seed += 1
        print(f"[multigb] corpus written: {n_bytes} bytes", flush=True)

    from mhc import api

    dst = os.path.join(work, "multigb.mhc")
    back = os.path.join(work, "multigb.out")
    t0 = time.perf_counter()
    stats = api.compress_file(src, dst, mode="markov",
                              segment_size=seg_mb << 20)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dstats = api.decompress_file(dst, back)
    dec_s = time.perf_counter() - t0

    # byte-compare streamed (no 2 GB in RAM)
    ok = True
    with open(src, "rb") as a, open(back, "rb") as b:
        while True:
            x = a.read(1 << 24)
            y = b.read(1 << 24)
            if x != y:
                ok = False
                break
            if not x:
                break
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    res = {
        "bytes": n_bytes,
        "segment_mb": seg_mb,
        "n_segments": stats["n_segments"],
        "ratio": round(stats["ratio"], 6),
        "encode_s": round(enc_s, 1),
        "decode_s": round(dec_s, 1),
        "encode_MBps": round(n_bytes / enc_s / 1e6, 1),
        "decode_MBps": round(n_bytes / dec_s / 1e6, 1),
        "roundtrip_ok": ok,
        "peak_rss_GB": round(rss_gb, 2),
    }
    print(json.dumps(res), flush=True)
    os.unlink(back)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
