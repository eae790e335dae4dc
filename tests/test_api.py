"""Golden/differential roundtrip tests over the public API (SURVEY.md §4:
'bit-exact roundtrip on every corpus ... plus adversarial inputs')."""

import numpy as np
import pytest

from mhc import api, container
from tests.corpus import ADVERSARIAL, english_like, mixed_binary


@pytest.mark.parametrize("mode", ["huffman", "markov"])
@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_adversarial_roundtrip(mode, name):
    data = ADVERSARIAL[name]
    blob = api.compress(data, mode=mode, block_size=4096)
    assert api.decompress(blob) == data


@pytest.mark.parametrize("mode", ["huffman", "markov"])
def test_text_roundtrip_1mb(mode):
    data = english_like(1 << 20)
    blob = api.compress(data, mode=mode)
    assert api.decompress(blob) == data
    rep = api.compression_report(data, blob)
    assert rep["ratio"] < 0.75  # entropy coding must actually compress text


def test_markov_beats_order0_on_text():
    data = english_like(1 << 20)
    b0 = api.compress(data, mode="huffman")
    bm = api.compress(data, mode="markov")
    assert len(bm) < len(b0)


@pytest.mark.parametrize("mode", ["huffman", "markov"])
def test_mixed_binary_roundtrip(mode):
    data = mixed_binary(1 << 20)
    blob = api.compress(data, mode=mode, block_size=64 * 1024)
    assert api.decompress(blob) == data


def test_block_size_variants():
    data = english_like(200_000, seed=5)
    for bs in (1024, 4096, 65536, 1 << 20):
        blob = api.compress(data, mode="markov", block_size=bs)
        assert api.decompress(blob) == data


def test_crc_detects_corruption():
    data = english_like(100_000)
    blob = bytearray(api.compress(data, mode="markov"))
    meta = container.parse_container(bytes(blob))
    blob[meta.payload_off + 10] ^= 0xFF  # flip payload bits
    with pytest.raises(ValueError, match="crc32"):
        api.decompress(bytes(blob))


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="magic"):
        api.decompress(b"NOPE" + b"\x00" * 40)


def test_truncated_rejected():
    data = english_like(100_000)
    blob = api.compress(data, mode="markov")
    with pytest.raises(ValueError):
        api.decompress(blob[:30])


def test_container_stat_fields():
    data = english_like(300_000)
    blob = api.compress(data, mode="markov", block_size=65536)
    rep = api.compression_report(data, blob)
    assert rep["n_blocks"] == 5
    assert rep["header_bytes"] + rep["table_bytes"] + rep["index_bytes"] \
        + rep["payload_bytes"] + 4 == rep["compressed_bytes"]


def test_histogram_methods_agree_through_api():
    data = mixed_binary(300_000, seed=9)
    b1 = api.compress(data, mode="markov", hist_method="scatter")
    b2 = api.compress(data, mode="markov", hist_method="matmul")
    assert b1 == b2  # determinism across histogram backends


def test_chunked_pipeline_container_identical(monkeypatch):
    """Chunked device pipeline (any MHC_CHUNK_MB) must produce containers
    byte-identical to the monolithic path, for both modes and both payload
    marshalling paths (device compact on/off)."""
    data = mixed_binary(3 << 20, seed=11)
    monkeypatch.setenv("MHC_CHUNK_MB", "64")
    ref = {m: api.compress(data, mode=m) for m in ("markov", "huffman")}
    for chunk_mb in ("1", "2"):
        monkeypatch.setenv("MHC_CHUNK_MB", chunk_mb)
        for m in ("markov", "huffman"):
            blob = api.compress(data, mode=m)
            assert blob == ref[m], (m, chunk_mb)
            assert api.decompress(blob) == data
    monkeypatch.setenv("MHC_DEVICE_COMPACT", "0")
    monkeypatch.setenv("MHC_CHUNK_MB", "1")
    blob = api.compress(data, mode="markov")
    assert blob == ref["markov"]
    assert api.decompress(blob) == data
