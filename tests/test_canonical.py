"""Unit tests: canonical code assignment + O(1) window decode tables."""

import numpy as np
import jax.numpy as jnp
import pytest

from mhc.ops import canonical, huffman


def _random_lengths(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5000, size=256).astype(np.int32)
    counts[rng.random(256) < 0.4] = 0
    return huffman.code_lengths_np(counts).astype(np.int32)


@pytest.mark.parametrize("seed", range(8))
def test_prefix_free(seed):
    lens = _random_lengths(seed)
    t = canonical.canonical_codes(jnp.array(lens))
    codes = np.array(t["codes"]); L = np.array(t["lengths"])
    present = np.nonzero(L > 0)[0]
    seen = set()
    for s in present:
        # left-aligned interval occupied by this code
        lo = int(codes[s]) << (huffman.MAX_CODE_LEN - int(L[s]))
        hi = (int(codes[s]) + 1) << (huffman.MAX_CODE_LEN - int(L[s]))
        for other in seen:
            assert hi <= other[0] or lo >= other[1], (s, lo, hi, other)
        seen.add((lo, hi))


@pytest.mark.parametrize("seed", range(8))
def test_np_vs_jax_tables(seed):
    lens = _random_lengths(seed)
    tj = canonical.canonical_codes(jnp.array(lens))
    tn = canonical.canonical_codes_np(lens)
    for k in ("codes", "lim", "base", "first_code", "sorted_syms"):
        assert (np.array(tj[k]) == tn[k]).all(), k


@pytest.mark.parametrize("seed", range(8))
def test_window_decode_resolves_every_symbol(seed):
    lens = _random_lengths(seed)
    t = canonical.canonical_codes(jnp.array(lens))
    codes = np.array(t["codes"]); L = np.array(t["lengths"])
    present = np.nonzero(L > 0)[0]
    ML = huffman.MAX_CODE_LEN
    # every code, left-aligned with arbitrary garbage bits after it,
    # must decode back to (symbol, length)
    rng = np.random.default_rng(seed)
    for s in present:
        garbage = int(rng.integers(0, 1 << (ML - int(L[s]))))
        window = (int(codes[s]) << (ML - int(L[s]))) | garbage
        sym, ln = canonical.decode_symbol(
            jnp.array([window], jnp.uint32),
            t["lim"][None, :], t["base"][None, :],
            t["first_code"][None, :], t["sorted_syms"][None, :])
        assert int(ln[0]) == int(L[s]), (s, int(ln[0]), int(L[s]))
        assert int(sym[0]) == s, (s, int(sym[0]))


def test_single_symbol_context():
    lens = np.zeros(256, np.int32); lens[9] = 1
    t = canonical.canonical_codes(jnp.array(lens))
    sym, ln = canonical.decode_symbol(
        jnp.array([0], jnp.uint32), t["lim"][None, :], t["base"][None, :],
        t["first_code"][None, :], t["sorted_syms"][None, :])
    assert int(sym[0]) == 9 and int(ln[0]) == 1
