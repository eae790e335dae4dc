"""Compression-ratio results table: mhc vs the C++ oracle.

The reference repo's main artifact besides the code is a README results
table over a small corpus (SURVEY.md §1/§2b). This reproduces that
artifact: per-corpus compressed sizes for order-0 and Markov mode, ours
vs the oracle, written to RESULTS.md.

Run: python bench/ratios.py   (CPU is fine; containers are backend-
independent byte-for-byte)
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def corpora():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from corpus import english_like, mixed_binary
    rng = np.random.default_rng(7)
    import bench as bench_mod  # repo-root bench.py for make_corpus
    return {
        "english_1MB": english_like(1 << 20),
        "mixed_1MB": mixed_binary(1 << 20),
        "bench_mixed_4MB": bench_mod.make_corpus(4 << 20),
        "random_1MB": rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
        "zeros_1MB": b"\x00" * (1 << 20),
        "counters_1MB": np.arange(1 << 18, dtype="<u4").tobytes(),
    }


def oracle_sizes(data: bytes) -> dict:
    exe = os.path.join(REPO, "oracle", "mh_oracle")
    if not os.path.exists(exe):
        subprocess.run(["make", "-C", os.path.join(REPO, "oracle")],
                       capture_output=True, check=True)
    out = {}
    with tempfile.NamedTemporaryFile() as f, \
            tempfile.NamedTemporaryFile() as g:
        f.write(data)
        f.flush()
        for mode, arg in (("huffman", "e0"), ("markov", "em")):
            subprocess.run([exe, arg, f.name, g.name], check=True)
            out[mode] = os.path.getsize(g.name)
    return out


def main() -> int:
    from mhc import api

    rows = []
    for name, data in corpora().items():
        osz = oracle_sizes(data)
        row = {"corpus": name, "bytes": len(data)}
        for mode in ("huffman", "markov"):
            blob = api.compress(data, mode=mode)
            rt = api.decompress(blob)
            assert rt == data, (name, mode)
            row[f"{mode}_ours"] = len(blob)
            row[f"{mode}_oracle"] = osz[mode]
        rows.append(row)
        print(row)

    lines = [
        "# RESULTS — compressed sizes, mhc vs C++ reference oracle",
        "",
        "Roundtrip bit-exactness asserted for every cell. `vs` = ours /",
        "oracle (< 1.0 means the mhc container is smaller). Generated by",
        "`bench/ratios.py`; deterministic corpora.",
        "",
        "All BASELINE.json benchmark configs (order-0 on 1 MB text; markov",
        "on everything) come in below the oracle. Non-benchmark order-0 on",
        "mixed corpora can run ~0.01% over: order-0 payload bits are",
        "identical to the oracle's by construction, our lengths-only table",
        "saves only ~117 B, and mixed content makes per-unit stream",
        "lengths high-entropy (a wide packed index) — the cost of the",
        "block-parallel format the parallel decoder requires.",
        "",
        "| corpus | bytes | order-0 ours | order-0 oracle | vs | markov ours | markov oracle | vs |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        v0 = r["huffman_ours"] / r["huffman_oracle"]
        vm = r["markov_ours"] / r["markov_oracle"]
        lines.append(
            f"| {r['corpus']} | {r['bytes']} | {r['huffman_ours']} | "
            f"{r['huffman_oracle']} | {v0:.4f} | {r['markov_ours']} | "
            f"{r['markov_oracle']} | {vm:.4f} |")
    out = "\n".join(lines) + "\n"
    # preserve every analysis section below the generated table (the
    # round-N measurement records) — only the header+table is replaced
    path = os.path.join(REPO, "RESULTS.md")
    tail = ""
    if os.path.exists(path):
        old = open(path).read()
        cut = old.find("\n## ")
        if cut != -1:
            tail = old[cut:]
    with open(path, "w") as f:
        f.write(out + tail)
    print("wrote RESULTS.md (table replaced, sections preserved)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
