"""Canonical Huffman codes and O(1) decode tables from code lengths.

Capability parity: the reference assigns codes by walking its Huffman tree
and re-canonicalizing (SURVEY.md §2 L2; mount empty, see §0). Batched
redesign: codes are a pure function of the lengths vector, computed with
prefix sums and one argsort — no tree, fully vectorized over contexts.

Bit convention: MSB-first canonical codes (DEFLATE-style numbering:
shorter codes are numerically smaller when left-aligned). The decoder
peeks a fixed MAX_CODE_LEN-bit window `w` and resolves the symbol length
as the smallest l with w < lim[l], where
    lim[l] = (first_code[l] + bl_count[l]) << (MAX_CODE_LEN - l),
then looks the symbol up by rank. Both steps are branchless vector ops.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from .huffman import MAX_CODE_LEN


@partial(jax.jit, static_argnames=("max_len",))
def canonical_codes(lengths: jnp.ndarray, max_len: int = MAX_CODE_LEN):
    """Canonical codes + decode tables from lengths.

    lengths: (..., 256) int32, 0 = absent symbol.
    Returns dict of arrays (all batched over leading dims):
      codes:       (..., 256) uint32  canonical code (right-aligned)
      lengths:     (..., 256) int32   pass-through
      lim:         (..., max_len+1) uint32  decode window limits, lim[0]=0
      base:        (..., max_len+1) int32   rank base per length
      first_code:  (..., max_len+1) int32
      sorted_syms: (..., 256) int32   symbols ordered by (length, symbol)
    """
    n = lengths.shape[-1]
    ls = jnp.arange(max_len + 1)
    # bl_count[..., l]
    onehot = (lengths[..., None] == ls).astype(jnp.int32)  # (..., 256, L+1)
    bl_count = onehot.sum(axis=-2)
    bl_count = bl_count.at[..., 0].set(0)

    # first_code[l] = (first_code[l-1] + bl_count[l-1]) << 1
    def fc_step(carry, blc):
        code = (carry + blc) << 1
        return code, code

    blc_t = jnp.moveaxis(bl_count, -1, 0)  # (L+1, ...)
    _, fcs = jax.lax.scan(fc_step, jnp.zeros(bl_count.shape[:-1], jnp.int32),
                          blc_t[:-1])
    first_code = jnp.concatenate(
        [jnp.zeros_like(fcs[:1]), fcs], axis=0)  # (L+1, ...) first_code[0]=0
    first_code = jnp.moveaxis(first_code, 0, -1)  # (..., L+1)

    # base[l] = number of symbols with 0 < length < l
    base = jnp.cumsum(bl_count, axis=-1) - bl_count

    # rank within same length: sort symbols by (length, symbol); absent last
    present = lengths > 0
    sortkey = jnp.where(present, lengths, max_len + 1) * n + jnp.arange(n)
    sorted_syms = jnp.argsort(sortkey, axis=-1).astype(jnp.int32)
    global_rank = jnp.argsort(sorted_syms, axis=-1)  # rank of each symbol
    lens_cl = jnp.clip(lengths, 0, max_len)
    rank_within = global_rank - jnp.take_along_axis(base, lens_cl, axis=-1)
    codes = jnp.take_along_axis(first_code, lens_cl, axis=-1) + rank_within
    codes = jnp.where(present, codes, 0).astype(jnp.uint32)

    # decode limits, left-aligned to the max_len-bit window
    lim = ((first_code + bl_count).astype(jnp.uint32)
           << (max_len - ls).astype(jnp.uint32))
    # lengths with bl_count == 0 must never be selected: a canonical-valid
    # window always hits a populated length first because lim is flat across
    # unpopulated lengths (first_code+0 re-encodes the same boundary).
    lim = lim.at[..., 0].set(0)

    return {
        "codes": codes,
        "lengths": lengths,
        "lim": lim,
        "base": base,
        "first_code": first_code,
        "sorted_syms": sorted_syms,
    }


def decode_length_from_window(window: jnp.ndarray, lim: jnp.ndarray,
                              max_len: int = MAX_CODE_LEN) -> jnp.ndarray:
    """Branchless canonical length resolve.

    window: (...,) uint32 — next max_len bits of the stream, left-aligned
            into the low max_len bits (i.e. value in [0, 2**max_len)).
    lim:    (..., max_len+1) uint32 decode limits for the active context.
    Returns (...,) int32 code length in [1, max_len].

    len = 1 + #{ l in 1..max_len-1 : window >= lim[l] }  (lim nondecreasing).
    """
    ge = (window[..., None] >= lim[..., 1:max_len]).astype(jnp.int32)
    return 1 + ge.sum(axis=-1)


def decode_symbol(window: jnp.ndarray, tables_lim, tables_base,
                  tables_first, tables_sorted, max_len: int = MAX_CODE_LEN):
    """Resolve (symbol, length) from a peeked window for batched streams.

    All table args are pre-gathered for the active context:
      tables_lim (..., L+1) uint32, tables_base (..., L+1) int32,
      tables_first (..., L+1) int32, tables_sorted (..., 256) int32.
    """
    length = decode_length_from_window(window, tables_lim, max_len)
    code = (window >> (max_len - length).astype(jnp.uint32)).astype(jnp.int32)
    idx = (jnp.take_along_axis(tables_base, length[..., None], axis=-1)[..., 0]
           + code
           - jnp.take_along_axis(tables_first, length[..., None], axis=-1)[..., 0])
    idx = jnp.clip(idx, 0, tables_sorted.shape[-1] - 1)
    sym = jnp.take_along_axis(tables_sorted, idx[..., None], axis=-1)[..., 0]
    return sym, length


# ---------------------------------------------------------------------------
# numpy mirrors (tests + host-side container handling)
# ---------------------------------------------------------------------------

def canonical_codes_np(lengths: np.ndarray, max_len: int = MAX_CODE_LEN):
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[-1]
    bl = np.zeros(lengths.shape[:-1] + (max_len + 1,), np.int64)
    for l in range(1, max_len + 1):
        bl[..., l] = (lengths == l).sum(axis=-1)
    first = np.zeros_like(bl)
    code = np.zeros(lengths.shape[:-1], np.int64)
    for l in range(1, max_len + 1):
        code = (code + bl[..., l - 1]) << 1
        first[..., l] = code
    base = np.cumsum(bl, axis=-1) - bl
    present = lengths > 0
    sortkey = np.where(present, lengths, max_len + 1) * n + np.arange(n)
    sorted_syms = np.argsort(sortkey, axis=-1, kind="stable")
    global_rank = np.argsort(sorted_syms, axis=-1, kind="stable")
    lens_cl = np.clip(lengths, 0, max_len)
    codes = (np.take_along_axis(first, lens_cl, axis=-1)
             + global_rank - np.take_along_axis(base, lens_cl, axis=-1))
    codes = np.where(present, codes, 0).astype(np.uint32)
    lim = ((first + bl) << (max_len - np.arange(max_len + 1))).astype(np.uint64)
    lim[..., 0] = 0
    return {
        "codes": codes,
        "lengths": lengths.astype(np.int32),
        "lim": np.minimum(lim, (1 << 32) - 1).astype(np.uint32),
        "base": base.astype(np.int32),
        "first_code": first.astype(np.int32),
        "sorted_syms": sorted_syms.astype(np.int32),
    }
