"""Unit tests: bit packer vs unpacker inverse (SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mhc.ops import bitpack, canonical, histogram, huffman


def _tables_for(data_blocks, n_valid, markov):
    if markov:
        counts = histogram.histogram_markov(
            jnp.array(data_blocks), jnp.array(n_valid), method="scatter")
    else:
        counts = histogram.histogram_order0(
            jnp.array(data_blocks), jnp.array(n_valid), method="scatter")
    lens = huffman.code_lengths(
        jnp.array(huffman.rescale_counts(np.array(counts))))
    t = canonical.canonical_codes(lens)
    if not markov:
        t = {k: jnp.broadcast_to(v, (256,) + v.shape) for k, v in t.items()}
    return t


def _roundtrip(payload: bytes, n: int, markov: bool):
    flat = np.frombuffer(payload, np.uint8)
    B = max(1, (len(payload) + n - 1) // n)
    blocks = np.zeros((B, n), np.uint8)
    nv = np.full(B, n, np.int32)
    nv[-1] = len(payload) - (B - 1) * n
    for i in range(B):
        ch = flat[i * n:(i + 1) * n]
        blocks[i, :len(ch)] = ch
    t = _tables_for(blocks, nv, markov)
    words, bits = bitpack.encode_blocks(
        jnp.array(blocks), jnp.array(nv), t["codes"], t["lengths"])
    dec = np.array(bitpack.decode_blocks(
        words, jnp.array(nv), t["lim"], t["base"], t["first_code"],
        t["sorted_syms"], n_out=n, markov=markov))
    out = np.concatenate([dec[i, :nv[i]] for i in range(B)]).tobytes()
    return out, np.array(bits)


@pytest.mark.parametrize("markov", [False, True])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_roundtrip_text(markov, n):
    payload = b"block parallel bit packing on the MXU " * 300
    out, bits = _roundtrip(payload, n, markov)
    assert out == payload
    assert (bits > 0).all()


@pytest.mark.parametrize("markov", [False, True])
def test_roundtrip_random(markov):
    payload = np.random.default_rng(0).integers(
        0, 256, 10_000, dtype=np.uint8).tobytes()
    out, _ = _roundtrip(payload, 512, markov)
    assert out == payload


def test_roundtrip_single_symbol_block():
    out, bits = _roundtrip(b"Z", 256, True)
    assert out == b"Z"
    assert int(bits[0]) >= 1


def test_bit_lengths_match_table_lengths():
    payload = b"abcabcabc" * 100
    flat = np.frombuffer(payload, np.uint8)
    n = 300
    B = len(payload) // n
    blocks = flat.reshape(B, n)
    nv = np.full(B, n, np.int32)
    t = _tables_for(blocks, nv, True)
    words, bits = bitpack.encode_blocks(
        jnp.array(blocks), jnp.array(nv), t["codes"], t["lengths"])
    lens_tab = np.array(t["lengths"])
    for b in range(B):
        prev = 0
        total = 0
        for c in blocks[b]:
            total += lens_tab[prev, c]
            prev = c
        assert total == int(bits[b])


def test_word_marshalling_inverse():
    rng = np.random.default_rng(1)
    W = 20
    words = rng.integers(0, 1 << 32, (5, W), dtype=np.uint64).astype(np.uint32)
    bits = np.array([640, 631, 1, 64, 320])
    blocks = bitpack.words_to_block_bytes(words, bits)
    back = bitpack.block_bytes_to_words(blocks, W)
    for i, nb in enumerate((bits + 7) // 8):
        nw = int(nb // 4)
        assert (back[i, :nw] == words[i, :nw]).all()


def test_slice_compact_expand_match_gather_variants():
    """Scan-of-dynamic-slices compaction/expansion must be bit-identical
    to the flat-gather implementations."""
    import jax.numpy as jnp
    from mhc.ops import bitpack

    rng = np.random.default_rng(123)
    R, W = 37, 24
    words = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    word_lens = rng.integers(0, W + 1, R).astype(np.int32)
    word_lens[3] = 0
    offsets = np.zeros(R + 1, np.int32)
    np.cumsum(word_lens, out=offsets[1:])
    total = int(offsets[-1])
    pad = total + 13
    a = np.array(bitpack.device_compact_words(
        jnp.asarray(words), jnp.asarray(offsets), pad))
    b = np.array(bitpack.device_compact_words_slices(
        jnp.asarray(words), jnp.asarray(offsets), pad))
    assert (a == b).all()

    ex1 = np.array(bitpack.device_expand_words_u32(
        jnp.asarray(a), jnp.asarray(offsets), jnp.asarray(word_lens), W))
    ex2 = np.array(bitpack.device_expand_words_slices(
        jnp.asarray(a), jnp.asarray(offsets), jnp.asarray(word_lens), W))
    assert (ex1 == ex2).all()
