"""Sub-stream (decode unit) container layout tests."""

import numpy as np
import pytest

from mhc import api, container
from tests.corpus import english_like, mixed_binary


def test_substream_flag_set_and_parsed():
    data = english_like(300_000)
    blob = api.compress(data, mode="markov", block_size=65536,
                        decode_unit=2048)
    meta = container.parse_container(blob)
    assert meta.flags & container.FLAG_SUBSTREAMS
    assert meta.decode_unit == 2048
    assert len(meta.byte_lengths) == (300_000 + 2047) // 2048
    assert api.decompress(blob) == data


def test_legacy_when_unit_equals_block():
    data = english_like(100_000)
    blob = api.compress(data, mode="markov", block_size=4096,
                        decode_unit=4096)
    meta = container.parse_container(blob)
    assert not (meta.flags & container.FLAG_SUBSTREAMS)
    assert api.decompress(blob) == data


@pytest.mark.parametrize("du", [256, 1024, 2048, 8192])
def test_unit_sizes_roundtrip(du):
    data = mixed_binary(200_000, seed=13)
    blob = api.compress(data, mode="markov", block_size=65536,
                        decode_unit=du)
    assert api.decompress(blob) == data


def test_invalid_units_rejected():
    data = b"x" * 1000
    with pytest.raises(ValueError, match="power of two"):
        api.compress(data, block_size=65536, decode_unit=3000)
    with pytest.raises(ValueError, match="u16"):
        api.compress(data, block_size=1 << 20, decode_unit=1 << 17)
    with pytest.raises(ValueError, match="power of two"):
        api.compress(data, block_size=60000)


def test_substream_overhead_is_small():
    data = english_like(1 << 20)
    legacy = api.compress(data, mode="markov", block_size=65536,
                          decode_unit=65536)
    sub = api.compress(data, mode="markov", block_size=65536,
                       decode_unit=2048)
    # u16 index (2B / 2KB) + per-unit padding + context resets: ~0.43%
    # measured on 1MB english_like; must stay under 0.5%
    assert len(sub) < len(legacy) * 1.005


def test_ragged_tail_single_unit():
    for n in (1, 100, 2047, 2048, 2049, 4096):
        data = english_like(n, seed=n)
        blob = api.compress(data, mode="markov", decode_unit=2048)
        assert api.decompress(blob) == data


def test_index_pack_unpack_inverse():
    import numpy as np
    from mhc import container as C
    rng = np.random.default_rng(3)
    for lens in [rng.integers(0, 4000, 1000), np.full(64, 257),
                 np.array([0]), np.array([65535]), rng.integers(0, 2, 500)]:
        lens = lens.astype(np.int64)
        raw = C.pack_index(lens)
        back, off = C.unpack_index(b"xx" + raw, 2, len(lens))
        assert off == 2 + len(raw)
        assert (back == lens).all()


def test_table_serialize_parse_inverse():
    import numpy as np
    from mhc import container as C
    rng = np.random.default_rng(4)
    lens0 = rng.integers(0, 16, 256).astype(np.uint8)
    raw = C.serialize_tables(C.MODE_ORDER0, lens0)
    back, off = C.parse_tables(C.MODE_ORDER0, raw, 0)
    assert off == len(raw) and (back == lens0).all()
    lensM = rng.integers(0, 16, (256, 256)).astype(np.uint8)
    lensM[rng.random(256) < 0.5] = 0  # absent contexts
    raw = C.serialize_tables(C.MODE_MARKOV, lensM)
    back, off = C.parse_tables(C.MODE_MARKOV, raw, 0)
    assert off == len(raw) and (back == lensM).all()
