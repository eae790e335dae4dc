"""Hybrid host/device executor: bit-identity between the native C++ unit
codec and the device path, at every split fraction."""

import numpy as np
import pytest

from mhc import api, hybrid
from mhc.models.entropy import get_model
from mhc.ops import bitpack
from mhc.utils import native
from tests.corpus import english_like, mixed_binary

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_hybrid_container_identity(mode, frac):
    """Containers are a pure function of the input — the host/device
    split must be invisible in the bytes."""
    data = mixed_binary(500_000, seed=50)
    ref = api.compress(data, mode=mode)
    blob = hybrid.compress(data, mode=mode, host_fraction=frac)
    assert blob == ref


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
def test_hybrid_decompress_roundtrip(frac):
    data = english_like(400_000, seed=51)
    blob = api.compress(data, mode="markov")
    out = hybrid.decompress(blob, host_fraction=frac)
    assert out == data


def test_hybrid_decode_of_hybrid_blob():
    data = mixed_binary(300_000, seed=52)
    blob = hybrid.compress(data, mode="markov", host_fraction=0.6)
    assert hybrid.decompress(blob, host_fraction=0.4) == data


def test_native_hist_matches_device():
    data = mixed_binary(200_000, seed=53)
    model = get_model("markov")
    units, n_valid = api.blockify(data, 4096)
    import jax.numpy as jnp
    dev = np.asarray(model.histogram(
        jnp.asarray(units), jnp.asarray(n_valid))).astype(np.int64)
    host = native.hist_markov(np.frombuffer(data, np.uint8), 4096)
    np.testing.assert_array_equal(dev, host)
    o_dev = np.asarray(get_model("huffman").histogram(
        jnp.asarray(units), jnp.asarray(n_valid))).astype(np.int64)
    o_host = native.hist_order0(np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(o_dev, o_host)


def test_native_encode_units_matches_device_words():
    """Per-unit stream bytes from C++ == device merge packer output."""
    import jax.numpy as jnp
    data = english_like(64_000, seed=54)
    du = 4096
    model = get_model("markov")
    units, n_valid = api.blockify(data, du)
    counts = model.histogram(jnp.asarray(units), jnp.asarray(n_valid))
    lengths = model.lengths_from_counts(np.asarray(counts))
    tables = model.tables_from_lengths(lengths)
    words, bits = bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(n_valid),
        tables["codes"], tables["lengths"])
    dev_rows = np.asarray(words).astype(">u4").view(np.uint8).reshape(
        len(n_valid), -1)
    dev_bits = np.asarray(bits).astype(np.int64)
    packed = native.build_enc_table(np.asarray(lengths, np.uint8))
    rows, bit_lens = native.encode_units(
        np.frombuffer(data, np.uint8), du, packed, True,
        bitpack.words_for_block(du) * 4)
    np.testing.assert_array_equal(bit_lens, dev_bits)
    for i in range(len(bit_lens)):
        nb = (int(bit_lens[i]) + 7) // 8
        assert rows[i, :nb].tobytes() == dev_rows[i, :nb].tobytes()


def test_hybrid_empty_and_tiny():
    assert hybrid.decompress(hybrid.compress(b"", host_fraction=0.5)) == b""
    assert hybrid.decompress(hybrid.compress(b"x", host_fraction=1.0)) == b"x"
    assert hybrid.decompress(
        hybrid.compress(b"x", host_fraction=0.0)) == b"x"
