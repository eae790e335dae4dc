"""Differential test: hierarchical-merge packer == scatter packer, bit for
bit, across block shapes, ragged tails and degenerate inputs."""

import numpy as np
import jax.numpy as jnp
import pytest

from mhc.ops import bitpack, canonical, histogram, huffman


def _tables(blocks, nv):
    cm = histogram.histogram_markov(jnp.array(blocks), jnp.array(nv),
                                    method="scatter")
    lx = huffman.code_lengths(jnp.array(huffman.rescale_counts(np.array(cm))))
    return canonical.canonical_codes(lx)


@pytest.mark.parametrize("B,n,seed", [(4, 256, 0), (3, 1000, 1), (2, 4096, 2),
                                      (5, 64, 3), (1, 8192, 4), (7, 333, 5)])
def test_merge_equals_scatter(B, n, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (B, n), dtype=np.uint8)
    nv = rng.integers(1, n + 1, B).astype(np.int32)
    nv[0] = n
    t = _tables(blocks, nv)
    w1, b1 = bitpack.encode_blocks(jnp.array(blocks), jnp.array(nv),
                                   t["codes"], t["lengths"])
    w2, b2 = bitpack.encode_blocks_merge(jnp.array(blocks), jnp.array(nv),
                                         t["codes"], t["lengths"])
    assert (np.array(b1) == np.array(b2)).all()
    assert (np.array(w1) == np.array(w2)).all()


def test_merge_single_symbol_and_empty_blocks():
    blocks = np.zeros((3, 128), np.uint8)
    blocks[0, 0] = 65
    nv = np.array([1, 0, 128], np.int32)
    t = _tables(blocks, nv)
    w1, b1 = bitpack.encode_blocks(jnp.array(blocks), jnp.array(nv),
                                   t["codes"], t["lengths"])
    w2, b2 = bitpack.encode_blocks_merge(jnp.array(blocks), jnp.array(nv),
                                         t["codes"], t["lengths"])
    assert (np.array(b1) == np.array(b2)).all()
    assert (np.array(w1) == np.array(w2)).all()
    assert int(np.array(b2)[1]) == 0


def test_merge_roundtrips_through_decoder():
    rng = np.random.default_rng(9)
    payload = (b"merge pack roundtrip " * 400)[:8000]
    n = 1024
    B = (len(payload) + n - 1) // n
    blocks = np.zeros((B, n), np.uint8)
    fl = np.frombuffer(payload, np.uint8)
    nv = np.full(B, n, np.int32)
    nv[-1] = len(payload) - (B - 1) * n
    for i in range(B):
        ch = fl[i * n:(i + 1) * n]
        blocks[i, :len(ch)] = ch
    t = _tables(blocks, nv)
    w, b = bitpack.encode_blocks_merge(jnp.array(blocks), jnp.array(nv),
                                       t["codes"], t["lengths"])
    dec = np.array(bitpack.decode_blocks(
        w, jnp.array(nv), t["lim"], t["base"], t["first_code"],
        t["sorted_syms"], n_out=n, markov=True))
    out = np.concatenate([dec[i, :nv[i]] for i in range(B)]).tobytes()
    assert out == payload
