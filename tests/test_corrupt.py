"""Corruption robustness: a damaged container must raise a clean
ValueError or return provably-correct bytes — never crash, hang, or
silently return garbage (crc gate). SURVEY.md §5: 'corrupt header/
bitstream -> clean error, not garbage output'."""

import numpy as np
import pytest

from mhc import api
from tests.corpus import english_like


@pytest.fixture(scope="module")
def blob():
    return api.compress(english_like(60_000, seed=77), mode="markov",
                        block_size=4096)


@pytest.fixture(scope="module")
def data():
    return english_like(60_000, seed=77)


def _try(blob_bytes, data):
    try:
        out = api.decompress(bytes(blob_bytes))
    except ValueError:
        return "error"
    except Exception as e:  # noqa: BLE001
        raise AssertionError(f"non-ValueError escaped: {type(e).__name__}: {e}")
    return "ok" if out == data else "WRONG"


def test_truncation_every_boundary(blob, data):
    for cut in [0, 1, 7, 8, 23, 24, 100, len(blob) // 2, len(blob) - 5,
                len(blob) - 1]:
        assert _try(blob[:cut], data) == "error", cut


def test_random_truncations(blob, data):
    rng = np.random.default_rng(0)
    for _ in range(25):
        cut = int(rng.integers(0, len(blob)))
        assert _try(blob[:cut], data) == "error", cut


def test_bit_flips_everywhere(blob, data):
    rng = np.random.default_rng(1)
    arr = np.frombuffer(blob, np.uint8).copy()
    for _ in range(40):
        pos = int(rng.integers(0, arr.size))
        bit = 1 << int(rng.integers(0, 8))
        mutated = arr.copy()
        mutated[pos] ^= bit
        res = _try(mutated.tobytes(), data)
        assert res in ("error", "ok"), (pos, bit, res)
        # "ok" can only legitimately happen if the flip was in a padding
        # nibble that does not affect decode; crc must catch everything
        # else. "WRONG" (silent corruption) is the failure we forbid.


def test_appended_garbage_single_decompress(blob, data):
    # decompress of a single container ignores trailing bytes only if
    # they aren't reachable; decompress reads exactly one container
    out = api.decompress(blob + b"garbage-tail")
    assert out == data


def test_extreme_header_values():
    # absurd orig_len / n_blocks must not allocate absurd memory or crash
    import struct
    head = struct.pack("<4sBBBBQII", b"MHTC", 1, 1, 0, 0,
                       1 << 62, 65536, 1 << 30)
    with pytest.raises(ValueError):
        api.decompress(head)
