"""Randomized differential fuzzing (SURVEY.md §4 golden/differential;
VERDICT r3 missing #3: all prior corpora were fixed-seed).

Every run draws a FRESH seed (printed on failure for reproduction via
MHC_FUZZ_SEED), builds a random corpus mix, and sweeps random
(mode, block_size, decode_unit, pack_method) configs asserting:

  * bit-exact roundtrip,
  * cross-path container byte-identity (merge vs scatter packers — the
    format is a pure function of (bytes, params), CLAUDE.md invariant),
  * compressed size <= the C++ oracle's on the default-parameter configs
    (the binding "size <= reference" contract, SURVEY.md §0),
  * corrupt-input rejection on a random byte flip (crc gate).
"""

from __future__ import annotations

import os
import struct
import subprocess
import tempfile

import numpy as np
import pytest

from mhc import api, container
from tests.corpus import english_like, mixed_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = int(os.environ.get("MHC_FUZZ_SEED",
                          str(struct.unpack("<I", os.urandom(4))[0])))


def _random_corpus(rng: np.random.Generator, n: int) -> bytes:
    """Random mix of text / binary / runs / noise segments."""
    out = bytearray()
    while len(out) < n:
        kind = rng.integers(5)
        seg = int(rng.integers(1, max(n // 4, 2)))
        if kind == 0:
            out += english_like(seg, seed=int(rng.integers(1 << 30)))
        elif kind == 1:
            out += mixed_binary(seg, seed=int(rng.integers(1 << 30)))
        elif kind == 2:
            out += bytes([int(rng.integers(256))]) * seg
        elif kind == 3:
            out += rng.integers(0, 256, seg, dtype=np.uint8).tobytes()
        else:
            pat = rng.integers(0, 256, int(rng.integers(1, 9)),
                               dtype=np.uint8).tobytes()
            out += pat * (seg // max(len(pat), 1) + 1)
    return bytes(out[:n])


def _oracle_size(data: bytes, mode: str) -> int:
    exe = os.path.join(REPO, "oracle", "mh_oracle")
    if not os.path.exists(exe):
        subprocess.run(["make", "-C", os.path.join(REPO, "oracle")],
                       capture_output=True, check=True)
    with tempfile.NamedTemporaryFile() as f, \
            tempfile.NamedTemporaryFile() as g:
        f.write(data)
        f.flush()
        arg = "e0" if mode == "huffman" else "em"
        subprocess.run([exe, arg, f.name, g.name], check=True,
                       capture_output=True)
        return os.path.getsize(g.name)


@pytest.mark.parametrize("iteration", range(4))
def test_fuzz_roundtrip_differential(iteration):
    rng = np.random.default_rng(SEED + iteration)
    n = int(rng.integers(1, 300_000))
    data = _random_corpus(rng, n)
    mode = ("markov", "huffman")[int(rng.integers(2))]
    block_size = int(2 ** rng.integers(12, 18))        # 4 KB .. 128 KB
    du_max = min(block_size, 16384)
    decode_unit = int(2 ** rng.integers(10, du_max.bit_length()))
    ctx = (f"seed={SEED} it={iteration} n={n} mode={mode} "
           f"bs={block_size} du={decode_unit}")

    blob = api.compress(data, mode=mode, block_size=block_size,
                        decode_unit=decode_unit, pack_method="merge")
    assert api.decompress(blob) == data, ctx
    # cross-path byte identity: scatter packer must emit the same bytes
    blob2 = api.compress(data, mode=mode, block_size=block_size,
                         decode_unit=decode_unit, pack_method="scatter")
    assert blob2 == blob, ctx
    # corrupt-input rejection: flip the FIRST byte of a random nonempty
    # unit stream -> clean error. (A fully random position can land in
    # per-unit alignment slack — up to 3 pad bytes + 31 unused bits in
    # the aligned layout — where the flip decodes identically; the first
    # byte holds the unit's first code bits, so any flip changes the
    # decoded prefix.)
    meta = container.parse_container(blob)
    bl = meta.byte_lengths.astype(np.int64)
    nonempty = np.nonzero(bl > 0)[0]
    if nonempty.size:
        r = int(nonempty[rng.integers(nonempty.size)])
        bad = bytearray(blob)
        pos = meta.payload_off + int(bl[:r].sum())
        bad[pos] ^= 1 + int(rng.integers(255))
        try:
            out = api.decompress(bytes(bad))
            assert out != data, ctx  # undetected-identical is impossible
            raise AssertionError(f"corruption not rejected: {ctx}")
        except ValueError:
            pass


def test_fuzz_size_vs_oracle():
    """Default-parameter containers on a random corpus must stay <= the
    C++ oracle's size (the BASELINE 'size <= reference' contract),
    UNCONDITIONALLY for both modes (VERDICT r4 #4). Round 5's literal
    units recover the order-0 expansion on incompressible segments that
    previously put mixed corpora ~0.01% over."""
    rng = np.random.default_rng(SEED)
    data = _random_corpus(rng, 1 << 20)
    for mode in ("markov", "huffman"):
        ours = len(api.compress(data, mode=mode))
        oracle = _oracle_size(data, mode)
        ctx = f"seed={SEED} mode={mode} ours={ours} oracle={oracle}"
        assert ours <= oracle, ctx
