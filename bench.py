"""Benchmark harness — prints ONE JSON line.

Headline metric (BASELINE.json:2, config :9): aggregate encode+decode
throughput of the Markov-Huffman codec on a 100 MB mixed text+binary
corpus with 64 KB blocks on one GPU, with a bit-exact roundtrip and
compressed size <= the C++ reference oracle.

The headline is measured DEVICE-RESIDENT (mhc/engine.py): input blocks,
payload, and output in device memory, host traffic limited to the table
header + unit index — the comparison against the C++ oracle, whose
input/output are likewise RAM-resident. The end-to-end container path
(host bytes -> container -> host bytes) is reported beside it (e2e_*).

vs_baseline: device-resident aggregate GB/s divided by the C++ oracle's
single-core aggregate GB/s on the identical corpus (the reference is
single-threaded and bit-serial — SURVEY.md §6; oracle measured fresh on
this machine).

Refuses to run without a GPU. Env knobs: MHC_BENCH_MB (default 100),
MHC_BENCH_MODE (markov), MHC_BENCH_REPS (2), MHC_BENCH_E2E=0 to skip the
e2e pass.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
WORK_DIR = os.path.join(REPO, ".cache", "bench")


def make_corpus(n_bytes: int, seed: int = 42) -> bytes:
    """Deterministic mixed corpus: structured binary + markov-ish text +
    incompressible noise, mirroring BASELINE.json:9 'mixed text+binary'."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"compression", b"entropy", b"huffman", b"markov",
             b"context", b"canonical", b"of", b"and", b"a", b"in", b"to"]
    while sum(map(len, parts)) < n_bytes:
        kind = rng.integers(0, 4)
        if kind == 0:  # text run
            chunk = bytearray()
            while len(chunk) < 1 << 16:
                chunk += words[rng.integers(len(words))]
                chunk += b" " if rng.random() < 0.85 else b".\n"
            parts.append(bytes(chunk))
        elif kind == 1:  # structured binary (counters)
            base = int(rng.integers(0, 1 << 24))
            parts.append(np.arange(base, base + (1 << 14), dtype="<u4").tobytes())
        elif kind == 2:  # repetitive
            parts.append(bytes(rng.integers(0, 256, 64, dtype=np.uint8)) * 1024)
        else:  # noise
            parts.append(rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes())
    return b"".join(parts)[:n_bytes]


def corpus_file(data: bytes, name: str) -> str:
    """Write `data` under the checkout's cache directory (for the oracle)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, name)
    if not (os.path.exists(path) and os.path.getsize(path) == len(data)):
        with open(path, "wb") as f:
            f.write(data)
    return path


def build_oracle() -> str:
    """Build oracle/mh_oracle from its committed source; return its path."""
    subprocess.run(["make", "-C", os.path.join(REPO, "oracle")],
                   capture_output=True, check=True, timeout=300)
    return os.path.join(REPO, "oracle", "mh_oracle")


def oracle_baseline(corpus_path: str, mode: str) -> dict:
    mode_arg = "em" if mode == "markov" else "e0"
    r = subprocess.run([build_oracle(), "bench", mode_arg, corpus_path],
                       capture_output=True, text=True, timeout=600,
                       check=True)
    return json.loads(r.stdout.strip())


def main() -> int:
    from mhc.utils import device
    dev = device.require_gpu()
    for line in device.header():
        print(line, file=sys.stderr)

    n_mb = int(os.environ.get("MHC_BENCH_MB", "100"))
    mode = os.environ.get("MHC_BENCH_MODE", "markov")
    reps = int(os.environ.get("MHC_BENCH_REPS", "2"))
    n_bytes = n_mb << 20
    data = make_corpus(n_bytes)
    corpus_path = corpus_file(data, f"corpus_{n_mb}mb.bin")

    import zlib

    import jax

    from mhc import api, engine

    # --- device-resident codec rate (headline) -----------------------
    st = engine.stage(data, mode=mode)           # h2d staging, untimed
    enc = engine.encode(st)                      # warm-up compiles
    outs = engine.decode(enc)
    assert engine.fetch_bytes(enc, outs) == data, "roundtrip mismatch"
    blob = engine.assemble_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
    del outs

    enc_t, dec_t = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        enc = engine.encode(st)
        jax.block_until_ready(enc.payload)
        enc_t.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        outs = engine.decode(enc)
        jax.block_until_ready(outs)
        dec_t.append(time.perf_counter() - t0)
        del outs
    enc_s = min(enc_t)
    dec_s = min(dec_t)
    agg_gbps = 2 * n_bytes / (enc_s + dec_s) / 1e9

    # --- e2e container path (host bytes -> container -> host bytes) ---
    e2e = {}
    if os.environ.get("MHC_BENCH_E2E", "1") != "0":
        api.decompress(api.compress(data, mode=mode))  # warm-up
        t0 = time.perf_counter()
        blob2 = api.compress(data, mode=mode)
        e2e_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = api.decompress(blob2)
        e2e_dec = time.perf_counter() - t0
        assert out == data, "e2e roundtrip mismatch"
        assert blob2 == blob, "engine/container mismatch"
        e2e = {
            "e2e_agg_GBps": 2 * n_bytes / (e2e_enc + e2e_dec) / 1e9,
            "e2e_encode_GBps": n_bytes / e2e_enc / 1e9,
            "e2e_decode_GBps": n_bytes / e2e_dec / 1e9,
        }

    base = oracle_baseline(corpus_path, mode)
    base_agg = 2 * n_bytes / (base["encode_s"] + base["decode_s"]) / 1e9

    print(json.dumps({
        "metric": f"device-resident encode+decode aggregate GB/s per GPU "
                  f"({mode}, {n_mb}MB, 64KB blocks)",
        "value": agg_gbps,
        "unit": "GB/s",
        "vs_baseline": agg_gbps / base_agg,
        "encode_GBps": n_bytes / enc_s / 1e9,
        "decode_GBps": n_bytes / dec_s / 1e9,
        "ratio": len(blob) / n_bytes,
        "ratio_vs_reference": len(blob) / base["compressed_bytes"],
        "oracle_agg_GBps": base_agg,
        **e2e,
        "device": dev,
        "card": device.card(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
