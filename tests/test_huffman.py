"""Unit tests: code-length assignment (SURVEY.md §4 'canonical-code
properties — prefix-free, Kraft <= 1, lengths match a scalar reference')."""

import numpy as np
import jax.numpy as jnp
import pytest

from mhc.ops import huffman


def kraft(lens):
    return sum(2.0 ** -int(l) for l in np.asarray(lens).ravel() if l > 0)


def optimal_cost(counts, lens):
    return int(np.sum(np.asarray(counts, np.int64) * np.asarray(lens, np.int64)))


def huffman_unlimited(counts):
    """Textbook heapq Huffman (independent oracle).

    Returns (total cost, max depth)."""
    import heapq
    h = [(int(c), i, 0) for i, c in enumerate(counts) if c > 0]
    if len(h) <= 1:
        return len(h) * int(sum(counts)), len(h)
    heapq.heapify(h)
    cost = 0
    maxd = 0
    while len(h) > 1:
        a = heapq.heappop(h)
        b = heapq.heappop(h)
        cost += a[0] + b[0]
        d = max(a[2], b[2]) + 1
        maxd = max(maxd, d)
        heapq.heappush(h, (a[0] + b[0], min(a[1], b[1]), d))
    return cost, maxd


@pytest.mark.parametrize("seed", range(10))
def test_np_vs_jax_identical(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 10_000, size=256).astype(np.int32)
    counts[rng.random(256) < rng.random()] = 0
    ln = huffman.code_lengths_np(counts).astype(int)
    lj = np.array(huffman.code_lengths(
        jnp.array(huffman.rescale_counts(counts))))
    assert (ln == lj).all()


@pytest.mark.parametrize("seed", range(10))
def test_kraft_and_optimality(seed):
    rng = np.random.default_rng(100 + seed)
    counts = rng.integers(0, 10_000, size=256).astype(np.int32)
    ln = huffman.code_lengths_np(counts).astype(int)
    assert kraft(ln) <= 1.0 + 1e-12
    unlimited_cost, unlimited_depth = huffman_unlimited(counts)
    if unlimited_depth <= huffman.MAX_CODE_LEN:
        # no limiting triggered -> must be exactly optimal
        assert optimal_cost(counts, ln) == unlimited_cost
    else:
        assert optimal_cost(counts, ln) <= unlimited_cost * 1.01 + 64


def test_degenerate_contexts():
    zero = np.zeros(256, np.int32)
    assert (huffman.code_lengths_np(zero) == 0).all()
    one = np.zeros(256, np.int32); one[42] = 999
    ln = huffman.code_lengths_np(one).astype(int)
    assert ln[42] == 1 and ln.sum() == 1
    two = np.zeros(256, np.int32); two[1] = 7; two[200] = 1
    ln = huffman.code_lengths_np(two).astype(int)
    assert ln[1] == 1 and ln[200] == 1 and ln.sum() == 2


def test_length_limit_skewed():
    fib = np.ones(256, np.int64)
    for i in range(2, 60):
        fib[i] = fib[i - 1] + fib[i - 2]
    counts = huffman.rescale_counts(fib)
    ln = huffman.code_lengths_np(counts).astype(int)
    lj = np.array(huffman.code_lengths(jnp.array(counts)))
    assert ln.max() <= huffman.MAX_CODE_LEN
    assert (ln == lj).all()
    assert kraft(ln) <= 1.0 + 1e-12
    # limited code must stay within 1% of the unlimited optimum on total bits
    unlimited, _ = huffman_unlimited(counts)
    assert optimal_cost(counts, ln) <= unlimited * 1.01 + 64


def test_vmapped_contexts():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 500, size=(256, 256)).astype(np.int32)
    counts[rng.random((256, 256)) < 0.6] = 0
    lj = np.array(huffman.code_lengths(
        jnp.array(huffman.rescale_counts(counts))))
    for ctx in range(0, 256, 37):
        ln = huffman.code_lengths_np(counts[ctx]).astype(int)
        assert (ln == lj[ctx]).all(), ctx


def test_rescale_preserves_support():
    counts = np.zeros(256, np.int64)
    counts[0] = 10 ** 12
    counts[1] = 1
    scaled = huffman.rescale_counts(counts)
    assert scaled[0] > 0 and scaled[1] > 0
    assert scaled.sum() < huffman._MAX_TOTAL
