"""Device-resident engine: roundtrip + container equivalence."""

import zlib

import numpy as np
import pytest

from mhc import api, engine
from tests.corpus import english_like, mixed_binary


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_engine_roundtrip(mode):
    data = mixed_binary(300_000, seed=40)
    st = engine.stage(data, mode=mode)
    enc = engine.encode(st)
    outs = engine.decode(enc)
    assert engine.fetch_bytes(enc, outs) == data


def test_engine_container_matches_api():
    """assemble_container must be byte-identical to api.compress."""
    data = english_like(200_000, seed=41)
    st = engine.stage(data, mode="markov")
    enc = engine.encode(st)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    blob = engine.assemble_container(enc, crc)
    assert blob == api.compress(data, mode="markov")
    # and the container decodes
    assert api.decompress(blob) == data


def test_engine_multi_chunk():
    data = mixed_binary(1_200_000, seed=42)
    st = engine.stage(data, mode="markov", chunk_units=64)
    assert len(st.units) > 1
    enc = engine.encode(st)
    outs = engine.decode(enc)
    assert engine.fetch_bytes(enc, outs) == data
    assert engine.assemble_container(enc, None) == api.compress(
        data, mode="markov", crc=False)


def test_engine_payload_matches_container_payload():
    data = english_like(150_000, seed=43)
    st = engine.stage(data, mode="markov")
    enc = engine.encode(st)
    blob = api.compress(data, mode="markov")
    from mhc import container
    meta = container.parse_container(blob)
    payload = blob[meta.payload_off:meta.payload_off
                   + int(meta.byte_lengths.sum())]
    assert engine.fetch_payload(enc) == payload
