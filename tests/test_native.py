"""Native host runtime: C++ marshalling == numpy fallback, and the
full pipeline round-trips identically with either."""

import numpy as np
import pytest

from mhc.utils import native


def _ref_join(rows, lens):
    mask = np.arange(rows.shape[1])[None, :] < lens[:, None]
    return rows[mask].tobytes()


def _ref_split(payload, lens, stride):
    buf = np.frombuffer(payload, np.uint8)
    rows = np.zeros((len(lens), stride), np.uint8)
    mask = np.arange(stride)[None, :] < lens[:, None]
    rows[mask] = buf[: int(lens.sum())]
    return rows


def test_native_lib_builds_and_loads():
    assert native.available(), "libmhc_host.so should build via make"


@pytest.mark.parametrize("seed", range(3))
def test_join_split_match_numpy(seed):
    rng = np.random.default_rng(seed)
    R, S = 1000, 64
    rows = rng.integers(0, 256, (R, S), dtype=np.uint8)
    lens = rng.integers(0, S + 1, R).astype(np.int64)
    joined = native.join_rows(rows, lens)
    assert joined == _ref_join(rows, lens)
    back = native.split_rows(joined, lens, S)
    assert (back == _ref_split(joined, lens, S)).all()
    # roundtrip: valid prefixes survive
    mask = np.arange(S)[None, :] < lens[:, None]
    assert (np.where(mask, back, 0) == np.where(mask, rows, 0)).all()


def test_empty_and_degenerate():
    rows = np.zeros((0, 16), np.uint8)
    lens = np.zeros((0,), np.int64)
    assert native.join_rows(rows, lens) == b""
    one = np.arange(16, dtype=np.uint8).reshape(1, 16)
    assert native.join_rows(one, np.array([0])) == b""
    assert native.join_rows(one, np.array([16])) == one.tobytes()


def test_container_roundtrip_uses_native():
    from mhc import api
    from tests.corpus import english_like
    data = english_like(200_000, seed=21)
    blob = api.compress(data, mode="markov")
    assert api.decompress(blob) == data
