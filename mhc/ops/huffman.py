"""Huffman code-length assignment — deterministic, length-limited.

Capability parity: reference builds one Huffman tree per context via greedy
two-least-frequent merges (SURVEY.md §3.4; reference mount empty, see §0).
Batched redesign: instead of a pointer-chasing tree, we compute *code
lengths only* with the two-queue merge algorithm expressed as fixed-trip
`lax.fori_loop`s over flat int32 arrays, `vmap`-able over all 256 Markov
contexts at once.  Canonical codes are derived from lengths downstream
(`canonical.py`), so the tree itself never needs to exist.

Determinism contract (required so every host builds bit-identical tables
before broadcast): ties are broken by (weight, then leaf-before-internal,
then lower symbol).  Lengths are limited to MAX_CODE_LEN via the standard
deflate-style overflow repair so the decoder can use O(1) canonical
peek-decode with a fixed 15-bit window.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

# Maximum code length. 15 bits => decoder peeks a fixed 15-bit window and
# resolves any symbol in O(1). Same limit as DEFLATE; cost vs unlimited
# Huffman is negligible (tested in tests/test_huffman.py).
MAX_CODE_LEN = 15

# Weight ceiling: counts are rescaled so the total stays below this, which
# keeps every internal-merge sum exactly representable in int32.
_MAX_TOTAL = 1 << 28
_INF = np.int64(1) << 40  # sentinel for numpy path


def rescale_counts(counts: np.ndarray) -> np.ndarray:
    """Scale down huge counts so totals fit int32; nonzero stays nonzero."""
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum(axis=-1, keepdims=True)
    shift = np.zeros_like(total)
    while np.any(total >> shift >= _MAX_TOTAL):
        shift = np.where(total >> shift >= _MAX_TOTAL, shift + 1, shift)
    scaled = counts >> shift
    scaled = np.where(counts > 0, np.maximum(scaled, 1), 0)
    return scaled.astype(np.int32)


def rescale_counts_jax(counts: jnp.ndarray) -> jnp.ndarray:
    """JAX mirror of `rescale_counts` for on-chip table builds after psum.

    counts: (..., 256) int32 (int32 totals are the wire format of the psum
    histogram reduction; per-cell counts beyond 2**31 are unsupported and
    must be pre-scaled by the caller). Bit-identical to the numpy version
    for all in-range inputs — required for cross-host table determinism.
    """
    counts = counts.astype(jnp.int32)
    total = jnp.sum(counts, axis=-1, keepdims=True)
    # shift = #k >= 0 with (total >> k) >= 2^28; int32 totals need k <= 3
    shift = sum(((total >> (28 + k)) > 0).astype(jnp.int32) for k in range(4))
    scaled = counts >> shift
    return jnp.where(counts > 0, jnp.maximum(scaled, 1), 0)


# ---------------------------------------------------------------------------
# numpy reference implementation (host oracle for tests + small inputs)
# ---------------------------------------------------------------------------

def code_lengths_np(counts: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Length-limited Huffman code lengths for one 256-symbol context.

    Two-queue merge over symbols sorted by (count, symbol); ties prefer the
    leaf queue. Absent symbols (count 0) get length 0. Returns (256,) uint8.
    """
    counts = rescale_counts(np.asarray(counts)).astype(np.int64)
    n = counts.shape[0]
    present = counts > 0
    m = int(present.sum())
    lengths = np.zeros(n, dtype=np.uint8)
    if m == 0:
        return lengths
    if m == 1:
        lengths[np.argmax(present)] = 1
        return lengths

    # sort leaves by (weight, symbol) ascending
    order = np.lexsort((np.arange(n), counts + np.where(present, 0, _INF)))
    leaf_w = counts[order]
    leaf_w = np.where(present[order], leaf_w, _INF)

    int_w = np.full(n, _INF, dtype=np.int64)     # internal node weights
    leaf_parent = np.full(n, -1, dtype=np.int32)  # parent internal idx per sorted leaf
    int_parent = np.full(n, -1, dtype=np.int32)
    i = 0  # leaf read ptr
    j = 0  # internal read ptr
    for t in range(m - 1):
        for pick in range(2):
            lw = leaf_w[i] if i < n else _INF
            iw = int_w[j] if j < t else _INF
            if lw <= iw:
                leaf_parent[i] = t
                w = lw
                i += 1
            else:
                int_parent[j] = t
                w = iw
                j += 1
            int_w[t] = (int_w[t] if pick else 0) + w
    # depths: root is internal m-2, parents have higher index
    depth = np.zeros(n, dtype=np.int32)
    for t in range(m - 3, -1, -1):
        depth[t] = depth[int_parent[t]] + 1
    sorted_lens = np.zeros(n, dtype=np.int32)
    for s in range(m):
        sorted_lens[s] = depth[leaf_parent[s]] + 1
    lengths_unsorted = np.zeros(n, dtype=np.int32)
    lengths_unsorted[order] = sorted_lens
    return limit_lengths_np(lengths_unsorted, max_len)


def limit_lengths_np(lengths: np.ndarray,
                     max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Kraft-budget overflow repair. Clamp lengths to max_len, then while the
    integer Kraft sum K = sum(2**(max_len-l)) exceeds the 2**max_len budget,
    demote one leaf from the deepest non-max level (cost: rarest symbols).
    A closed-form promotion pass then spends any leftover slack re-shortening
    the deepest codes. Canonical reassignment in (orig_len, symbol) order.
    Deterministic; mirrored exactly by the JAX `_limit_lengths_one`."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[0]
    over = int((lengths > max_len).sum())
    if over == 0:
        return lengths.astype(np.uint8)
    clamped = np.minimum(lengths, max_len)
    bl = np.bincount(clamped, minlength=max_len + 2).astype(np.int64)[: max_len + 1]
    bl[0] = 0
    budget = 1 << max_len
    K = int(sum(bl[l] << (max_len - l) for l in range(1, max_len + 1)))
    while K > budget:
        bits = max(l for l in range(1, max_len) if bl[l] > 0)
        bl[bits] -= 1
        bl[bits + 1] += 1
        K -= 1 << (max_len - bits - 1)
    slack = budget - K
    for l in range(max_len, 1, -1):
        cost = 1 << (max_len - l)
        k = min(int(bl[l]), slack // cost)
        bl[l] -= k
        bl[l - 1] += k
        slack -= k * cost
    # reassign: symbols ordered by (orig clamped length, symbol) get the new
    # nondecreasing lengths drawn from bl
    present_idx = np.nonzero(lengths > 0)[0]
    order = present_idx[np.lexsort((present_idx, clamped[present_idx]))]
    new_lens = np.zeros(n, dtype=np.uint8)
    fill = np.repeat(np.arange(max_len + 1), bl)
    new_lens[order] = fill
    return new_lens


# ---------------------------------------------------------------------------
# JAX implementation — vmap over contexts, fixed-shape lax loops
# ---------------------------------------------------------------------------

def _code_lengths_one(counts: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """Huffman lengths for one context. counts: (256,) int32 (pre-rescaled).
    Returns (256,) int32 lengths (0 = absent)."""
    n = counts.shape[0]
    INF = jnp.int32(2 ** 30)
    present = counts > 0
    m = jnp.sum(present.astype(jnp.int32))

    # sort leaves by (weight, symbol); absent pushed to the end
    key_w = jnp.where(present, counts, INF)
    order = jnp.argsort(key_w, stable=True)  # stable => symbol tiebreak
    leaf_w = jnp.where(present[order], counts[order], INF)
    leaf_w = jnp.concatenate([leaf_w, jnp.full((2,), INF, jnp.int32)])

    int_w0 = jnp.full((n + 2,), INF, jnp.int32)
    # parent pointers; scratch slot n holds masked writes
    leaf_parent0 = jnp.zeros((n + 3,), jnp.int32)
    int_parent0 = jnp.zeros((n + 3,), jnp.int32)

    def merge_step(t, st):
        i, j, leaf_parent, int_parent, int_w = st
        active = t < m - 1

        def pick(i, j, leaf_parent, int_parent):
            lw = leaf_w[i]
            iw = int_w[j]
            take_leaf = lw <= iw
            w = jnp.where(take_leaf, lw, iw)
            # masked writes route to scratch slot n (n+1 area)
            li = jnp.where(active & take_leaf, i, n + 1)
            ii = jnp.where(active & ~take_leaf, j, n + 1)
            leaf_parent = leaf_parent.at[li].set(t)
            int_parent = int_parent.at[ii].set(t)
            i = jnp.where(active & take_leaf, i + 1, i)
            j = jnp.where(active & ~take_leaf, j + 1, j)
            return i, j, leaf_parent, int_parent, w

        i, j, leaf_parent, int_parent, w1 = pick(i, j, leaf_parent, int_parent)
        i, j, leaf_parent, int_parent, w2 = pick(i, j, leaf_parent, int_parent)
        tw = jnp.where(active, w1 + w2, INF)
        int_w = int_w.at[jnp.where(active, t, n + 1)].set(tw)
        return i, j, leaf_parent, int_parent, int_w

    i, j, leaf_parent, int_parent, int_w = jax.lax.fori_loop(
        0, n - 1, merge_step,
        (jnp.int32(0), jnp.int32(0), leaf_parent0, int_parent0, int_w0))

    # depths of internal nodes, walking from root (index m-2) downward
    depth0 = jnp.zeros((n + 3,), jnp.int32)

    def depth_step(k, depth):
        t = n - 2 - k  # descend t = n-2 .. 0
        is_node = (t >= 0) & (t < m - 1)
        is_root = t == m - 2
        d = jnp.where(is_root, 0, depth[int_parent[t]] + 1)
        return depth.at[jnp.where(is_node, t, n + 1)].set(jnp.where(is_node, d, 0))

    depth = jax.lax.fori_loop(0, n - 1, depth_step, depth0)

    sidx = jnp.arange(n)
    sorted_lens = jnp.where(sidx < m, depth[leaf_parent[sidx]] + 1, 0)
    lengths = jnp.zeros((n,), jnp.int32).at[order].set(sorted_lens)

    # degenerate contexts
    single = jnp.where(present, 1, 0)
    lengths = jnp.where(m == 1, single, lengths)
    lengths = jnp.where(m == 0, jnp.zeros_like(lengths), lengths)
    return _limit_lengths_one(lengths, max_len)


def _limit_lengths_one(lengths: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """Kraft-budget overflow repair, one context (mirrors limit_lengths_np).

    Demotion runs in a `while_loop` so the common no-overflow case exits
    immediately even under vmap; the promotion pass is closed-form."""
    n = lengths.shape[0]
    over = jnp.sum((lengths > max_len).astype(jnp.int32))
    clamped = jnp.minimum(lengths, max_len)
    bl = jnp.zeros((max_len + 2,), jnp.int32).at[clamped].add(
        (lengths > 0).astype(jnp.int32))
    bl = bl.at[0].set(0)

    budget = jnp.int32(1 << max_len)
    ls = jnp.arange(max_len + 2, dtype=jnp.int32)
    weights = jnp.where((ls >= 1) & (ls <= max_len),
                        1 << jnp.clip(max_len - ls, 0, max_len), 0)
    K0 = jnp.sum(bl * weights)

    def demote_cond(st):
        _, K = st
        return K > budget

    def demote(st):
        bl, K = st
        cand = jnp.where((ls >= 1) & (ls < max_len) & (bl > 0), ls, -1)
        bits = jnp.max(cand)
        bl = bl.at[bits].add(-1)
        bl = bl.at[bits + 1].add(1)
        K = K - (1 << jnp.clip(max_len - bits - 1, 0, max_len))
        return bl, K

    bl, K = jax.lax.while_loop(demote_cond, demote, (bl, K0))

    slack = budget - K
    for l in range(max_len, 1, -1):  # static unroll, 14 steps
        cost = 1 << (max_len - l)
        k = jnp.minimum(bl[l], slack // cost)
        bl = bl.at[l].add(-k).at[l - 1].add(k)
        slack = slack - k * cost
    bl = bl.at[0].set(0)

    # reassign new lengths to symbols ordered by (clamped length, symbol)
    present = lengths > 0
    sortkey = jnp.where(present, clamped, max_len + 1) * n + jnp.arange(n)
    order = jnp.argsort(sortkey)
    # rank r in order gets length = smallest l with cumsum(bl)[l] > r
    cum = jnp.cumsum(bl[: max_len + 1])  # cum[l] = #codes with length <= l
    ranks = jnp.arange(n)
    new_sorted = jnp.searchsorted(cum, ranks, side='right')  # in 1..max_len
    new_sorted = jnp.where(ranks < jnp.sum(present.astype(jnp.int32)), new_sorted, 0)
    fixed = jnp.zeros((n,), jnp.int32).at[order].set(new_sorted)
    return jnp.where(over > 0, fixed, lengths)


@partial(jax.jit, static_argnames=("max_len",))
def code_lengths(counts: jnp.ndarray, max_len: int = MAX_CODE_LEN) -> jnp.ndarray:
    """Vectorized Huffman code lengths.

    counts: (..., 256) int32, already rescaled to total < 2**28 per context
    (use `rescale_counts` if needed). Returns (..., 256) int32 lengths.
    """
    flat = counts.reshape((-1, counts.shape[-1]))
    lens = jax.vmap(lambda c: _code_lengths_one(c, max_len))(flat)
    return lens.reshape(counts.shape)
