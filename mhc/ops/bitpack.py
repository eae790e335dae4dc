"""Block-parallel bit packing and unpacking.

Capability parity: the reference emits/reads one variable-length code at a
time through a bit-serial writer/reader (SURVEY.md §2 L0, §3.1-3.2 hot
loops; mount empty, §0). That serial chain is the single thing that cannot
run fast on a data-parallel accelerator, so the redesign restructures the
stream:

* Input is split into independent fixed-size blocks; the Markov context
  resets at each block boundary (container records per-block bit lengths).
* ENCODE is fully parallel: per-symbol code lengths -> exclusive prefix sum
  gives every symbol's absolute bit offset; each code straddles at most two
  32-bit words, so a pair of scatter-adds materialises the whole bitstream
  at once (disjoint bit ranges make add == or).
* DECODE is sequential per block but vectorized across thousands of blocks:
  a `lax.scan` peeks a fixed MAX_CODE_LEN-bit window per block per step and
  resolves (symbol, length) with branchless canonical arithmetic
  (`canonical.py`), advancing each block's bit cursor independently.
  `decode_blocks` is the reference; `ops/decode_kernel.py` runs the same
  loop inside one GPU kernel.

Bit order: MSB-first within each 32-bit word; words are big-endian when
serialized so the byte stream equals the conceptual MSB-first bitstream.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .huffman import MAX_CODE_LEN


def _flat_gather(table: jnp.ndarray, prev: jnp.ndarray,
                 cur: jnp.ndarray) -> jnp.ndarray:
    """table[(256,256)][prev, cur] as one flat 1-D gather."""
    return jnp.take(table.reshape(-1), prev * 256 + cur)


def _gather_codes_lens(code_table: jnp.ndarray, len_table: jnp.ndarray,
                       prev: jnp.ndarray, cur: jnp.ndarray):
    """Fused (code, len) lookup from a (len<<16 | code) packed table —
    codes are <= MAX_CODE_LEN bits so they pack with the 4-bit length
    into one u32 exactly."""
    packed = _gather_packed(code_table, len_table, prev, cur)
    return (packed & jnp.uint32(0xFFFF)).astype(jnp.uint32), \
        (packed >> 16).astype(jnp.int32)


def _gather_packed(code_table: jnp.ndarray, len_table: jnp.ndarray,
                   prev: jnp.ndarray, cur: jnp.ndarray) -> jnp.ndarray:
    """(len<<16 | code) u32 per symbol (half the memory traffic of
    separate code+len planes)."""
    packed_t = ((len_table.astype(jnp.uint32) << 16)
                | code_table.astype(jnp.uint32))
    return _flat_gather(packed_t, prev, cur)


def words_for_block(block_size: int, max_len: int = MAX_CODE_LEN) -> int:
    """u32 words needed to hold a worst-case encoded block, +1 slack word so
    the straddle scatter and the decode peek never index out of bounds."""
    return (block_size * max_len + 31) // 32 + 1


# ---------------------------------------------------------------------------
# Raw-literal units (round 5, container FLAG_RAW_UNITS). Huffman EXPANDS
# incompressible units (uniform-random bytes cost ~8.004 bits/symbol
# order-0 and ~0.75% extra under sparse markov contexts; under a
# text-skewed order-0 table, noise units pay the full cross-entropy
# gap). A unit whose packed stream would occupy at least the unit's own
# bytes in the container layout is stored as a LITERAL instead: the
# original bytes, big-endian word-packed, with bits = n_valid*8.
# Detection is length-based and unambiguous: after substitution a
# stored unit reaches the layout size of its original bytes IFF it is a
# literal (non-literal streams are strictly shorter — the encoder
# forces the substitution at >=).
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("aligned",))
def substitute_raw_units(words: jnp.ndarray, bits: jnp.ndarray,
                         units: jnp.ndarray, n_valid: jnp.ndarray,
                         aligned: bool):
    """Post-pack literal substitution. words (B, W) u32 packed streams,
    bits (B,), units (B, du) u8 (zero past n_valid), n_valid (B,).
    Returns (words', bits') with literal units' streams replaced by
    their original bytes (BE word-packed) and bits' = n_valid*8."""
    B, W = words.shape
    du = units.shape[1]
    b = bits.astype(jnp.int64)
    nv = n_valid.astype(jnp.int64)
    if aligned:
        raw = (b + 31) // 32 >= (nv + 3) // 4
    else:
        raw = (b + 7) // 8 >= nv
    pos = jnp.arange(du, dtype=jnp.int32)
    u = jnp.where(pos[None, :] < nv[:, None].astype(jnp.int32),
                  units.astype(jnp.uint32), 0).reshape(B, du // 4, 4)
    uw = ((u[..., 0] << 24) | (u[..., 1] << 16)
          | (u[..., 2] << 8) | u[..., 3])
    if W > du // 4:
        uw = jnp.concatenate(
            [uw, jnp.zeros((B, W - du // 4), jnp.uint32)], axis=1)
    else:
        uw = uw[:, :W]
    words_out = jnp.where(raw[:, None], uw, words)
    bits_out = jnp.where(raw, (nv * 8).astype(bits.dtype),
                         bits).astype(bits.dtype)
    return words_out, bits_out


def raw_unit_mask(stored_byte_lens: np.ndarray, n_valid: np.ndarray,
                  aligned: bool) -> np.ndarray:
    """Decode-side literal detection from the container index. Host
    numpy; stored_byte_lens are LAYOUT bytes (aligned: word-count*4)."""
    sl = np.asarray(stored_byte_lens, np.int64)
    nv = np.asarray(n_valid, np.int64)
    if aligned:
        return sl == ((nv + 3) // 4) * 4
    return sl == nv


@partial(jax.jit, static_argnames=("du",))
def words_to_unit_bytes(words: jnp.ndarray, du: int) -> jnp.ndarray:
    """(B, W) u32 BE stream words -> (B, du) u8 literal bytes (the
    decode-side inverse of the literal packing above). W may be
    narrower than du/4 when only a RAGGED final unit is literal (the
    stream buffer is sized by the max coded stream) — pad with zeros."""
    B, W = words.shape
    w = words[:, : du // 4]
    if W < du // 4:
        w = jnp.concatenate(
            [w, jnp.zeros((B, du // 4 - W), jnp.uint32)], axis=1)
    by = jnp.stack([(w >> 24) & 255, (w >> 16) & 255,
                    (w >> 8) & 255, w & 255], axis=-1)
    return by.reshape(B, du).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("max_len",))
def encode_blocks(data: jnp.ndarray, n_valid: jnp.ndarray,
                  code_table: jnp.ndarray, len_table: jnp.ndarray,
                  init_ctx: int = 0, max_len: int = MAX_CODE_LEN):
    """Encode a batch of blocks into bit-packed u32 words.

    data:       (B, n) uint8/int32 symbols (padded past n_valid with 0)
    n_valid:    (B,) int32 valid symbol count per block
    code_table: (256, 256) uint32 — [prev, cur] canonical code
    len_table:  (256, 256) int32  — [prev, cur] code length (order-0 callers
                pass context-independent rows)
    Returns (words (B, W) uint32, bit_lengths (B,) uint32).
    """
    data = data.astype(jnp.int32)
    B, n = data.shape
    W = words_for_block(n, max_len)

    prev = jnp.concatenate(
        [jnp.full((B, 1), init_ctx, jnp.int32), data[:, :-1]], axis=1)
    codes, lens = _gather_codes_lens(code_table, len_table, prev, data)
    pos = jnp.arange(n)[None, :]
    valid = pos < n_valid[:, None]
    lens = jnp.where(valid, lens, 0)
    codes = jnp.where(valid, codes, 0)

    offs = jnp.cumsum(lens, axis=1) - lens            # exclusive prefix sum
    total_bits = (offs[:, -1] + lens[:, -1]).astype(jnp.uint32)

    w0 = (offs >> 5).astype(jnp.int32)
    s = (offs & 31).astype(jnp.int32)
    left = 32 - s - lens                               # [-(max_len-1), 32]
    sl = jnp.clip(left, 0, 31).astype(jnp.uint32)
    sr = jnp.clip(-left, 0, 31).astype(jnp.uint32)
    part0 = jnp.where(left >= 0, codes << sl, codes >> sr).astype(jnp.uint32)
    s1 = jnp.clip(32 + left, 0, 31).astype(jnp.uint32)
    part1 = jnp.where(left < 0, codes << s1, jnp.uint32(0)).astype(jnp.uint32)

    b = jnp.arange(B)[:, None]
    words = jnp.zeros((B, W), jnp.uint32)
    words = words.at[b, w0].add(part0, mode="drop")
    words = words.at[b, w0 + 1].add(part1, mode="drop")
    return words, total_bits


@partial(jax.jit, static_argnames=("n_out", "max_len", "markov"))
def decode_blocks(words: jnp.ndarray, n_valid: jnp.ndarray,
                  lim: jnp.ndarray, base: jnp.ndarray,
                  first_code: jnp.ndarray, sorted_syms: jnp.ndarray,
                  n_out: int, init_ctx: int = 0,
                  max_len: int = MAX_CODE_LEN, markov: bool = True):
    """Decode a batch of blocks. Sequential over symbols, parallel over B.

    words:       (B, W) uint32 bit-packed streams (W >= needed + 1 slack)
    n_valid:     (B,) int32 symbols to produce per block
    lim:         (256, max_len+1) uint32 canonical window limits per context
    base/first_code: (256, max_len+1) int32
    sorted_syms: (256, 256) int32 symbols by (length, symbol) per context
    n_out:       static max symbols per block
    Returns (B, n_out) uint8 (entries past n_valid are 0).
    """
    B, W = words.shape
    Lp1 = max_len + 1
    lim_f = lim.reshape(-1)
    # single fused (base - first_code) table: one gather instead of two
    bf_f = (base.astype(jnp.int32) - first_code.astype(jnp.int32)).reshape(-1)
    sorted_f = sorted_syms.reshape(-1)
    barange = jnp.arange(B)

    def step(carry, t):
        bitpos, prev = carry
        w = (bitpos >> 5).astype(jnp.int32)
        s = (bitpos & 31).astype(jnp.uint32)
        hi = words[barange, w] << s
        w1 = jnp.minimum(w + 1, W - 1)
        lo_shift = (32 - s) & 31
        lo = jnp.where(s == 0, jnp.uint32(0), words[barange, w1] >> lo_shift)
        window = (hi | lo) >> jnp.uint32(32 - max_len)     # (B,) in [0, 2^L)

        ctx = prev if markov else jnp.zeros_like(prev)
        limr = lim_f.reshape(256, Lp1)[ctx]                 # (B, L+1)
        ge = (window[:, None] >= limr[:, 1:max_len]).astype(jnp.int32)
        length = 1 + ge.sum(axis=1)                         # (B,)
        code = (window >> (max_len - length).astype(jnp.uint32)).astype(jnp.int32)
        idx = jnp.clip(bf_f[ctx * Lp1 + length] + code, 0, 255)
        sym = sorted_f[ctx * 256 + idx]

        valid = t < n_valid
        bitpos = bitpos + jnp.where(valid, length, 0).astype(jnp.uint32)
        prev = jnp.where(valid, sym, prev)
        out = jnp.where(valid, sym, 0).astype(jnp.uint8)
        return (bitpos, prev), out

    carry0 = (jnp.zeros((B,), jnp.uint32),
              jnp.full((B,), init_ctx, jnp.int32))
    _, outs = jax.lax.scan(step, carry0, jnp.arange(n_out))
    return outs.T  # (B, n_out)


@partial(jax.jit, static_argnames=("max_len",))
def encode_blocks_merge(data: jnp.ndarray, n_valid: jnp.ndarray,
                        code_table: jnp.ndarray, len_table: jnp.ndarray,
                        init_ctx: int = 0, max_len: int = MAX_CODE_LEN):
    """Scatter-free encoder: hierarchical doubling merge.

    A scatter-add pack (encode_blocks) serializes on colliding indices
    where the backend has no fast atomics. This variant concatenates
    bitstrings by doubling instead: level k holds one MSB-first
    word buffer per 2^k consecutive symbols; merging two nodes is a per-node
    word-offset gather (tiny axis) + two shifts + OR — all dense vector ops.
    log2(n) levels, ~8 dense ops each, zero scatters. Bit-identical output
    to encode_blocks (tested).
    """
    data = data.astype(jnp.int32)
    B, n = data.shape
    W_final = words_for_block(n, max_len)

    prev = jnp.concatenate(
        [jnp.full((B, 1), init_ctx, jnp.int32), data[:, :-1]], axis=1)
    codes, lens = _gather_codes_lens(code_table, len_table, prev, data)
    valid = jnp.arange(n)[None, :] < n_valid[:, None]
    lens = jnp.where(valid, lens, 0)
    codes = jnp.where(valid, codes, 0)

    # pad symbol count to a power of two with zero-length nodes
    n_pow = 1 << (n - 1).bit_length()
    if n_pow != n:
        pad = n_pow - n
        lens = jnp.pad(lens, ((0, 0), (0, pad)))
        codes = jnp.pad(codes, ((0, 0), (0, pad)))

    # level 0: one MSB-aligned word per symbol
    shift0 = jnp.clip(32 - lens, 0, 31).astype(jnp.uint32)
    buf = (codes << shift0)[..., None]                     # (B, n_pow, 1)
    L = lens

    node_syms = 1
    W_in = 1
    while node_syms < n_pow:
        node_syms *= 2
        W_out = min((max_len * node_syms + 31) // 32, W_final)
        pairs_b = buf.reshape(B, -1, 2, W_in)
        left = pairs_b[:, :, 0]
        right = pairs_b[:, :, 1]
        pairs_l = L.reshape(B, -1, 2)
        llen = pairs_l[:, :, 0]
        rlen = pairs_l[:, :, 1]

        if W_out > W_in:
            right = jnp.pad(right, ((0, 0), (0, 0), (0, W_out - W_in)))
            left = jnp.pad(left, ((0, 0), (0, 0), (0, W_out - W_in)))

        # Shift `right` right by llen bits with a barrel shifter: one
        # masked UNIFORM shift per bit of llen. XLA lowers per-node
        # word-offset gathers quadratically (~584 GB touched per MB!);
        # static-slice shifts are plain dense ops.
        t = llen[..., None]                                 # (B, m, 1)
        # bit-level stages: 1, 2, 4, 8, 16
        for k in (1, 2, 4, 8, 16):
            hi = right >> jnp.uint32(k)
            lo = jnp.pad(right, ((0, 0), (0, 0), (1, 0)))[:, :, :-1] \
                << jnp.uint32(32 - k)
            right = jnp.where((t & k) != 0, hi | lo, right)
        # word-level stages: 1, 2, 4, ... words (32, 64, ... bits)
        wshift = 1
        while wshift * 32 <= max_len * (node_syms // 2):
            moved = jnp.pad(
                right, ((0, 0), (0, 0), (wshift, 0)))[:, :, :W_out]
            right = jnp.where((t & (32 * wshift)) != 0, moved, right)
            wshift *= 2

        buf = left | right
        L = llen + rlen
        W_in = W_out

    words = buf[:, 0, :]
    if W_final > W_in:
        words = jnp.pad(words, ((0, 0), (0, W_final - W_in)))
    return words, L[:, 0].astype(jnp.uint32)


# ---------------------------------------------------------------------------
# device-side payload compaction / expansion
#
# Transferring the padded (R, W) word matrices costs ~1.9x the input size
# on the host<->device link. These jits compact the byte-aligned unit
# streams into one dense payload ON DEVICE (and expand on decode), so
# only payload-sized buffers cross the link. Offsets are tiny host
# round-trips.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("wmax",))
def device_rows_to_bytes(words: jnp.ndarray, wmax: int) -> jnp.ndarray:
    """(R, W) uint32 words -> (R, wmax*4) uint8 big-endian byte rows,
    sliced to the chunk-wide max used width. Dense ops only — no gathers.
    The per-unit byte compaction then happens on host (native threaded
    memcpy), which beats the gather-bound on-device byte compaction by
    ~20x: the extra bytes transferred (chunk-max vs exact) cost far less
    than the 16M-position searchsorted+gather."""
    w = words[:, :wmax]
    b = jnp.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                   (w >> 8) & 0xFF, w & 0xFF], axis=-1)
    return b.reshape(w.shape[0], wmax * 4).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("total_pad",))
def device_compact_words(words: jnp.ndarray, word_offsets: jnp.ndarray,
                         total_pad: int) -> jnp.ndarray:
    """words (R, W) u32 + aligned unit WORD offsets (R+1,) int32 ->
    (total_pad,) u32 dense payload (big-endian byte semantics; positions
    past word_offsets[-1] are zero).

    The unit id of every output word comes from a scatter+cumsum over the
    unit boundaries — one dense pass — and the value from ONE flat
    gather. The byte compaction (device_compact_payload) does a 12-step
    searchsorted plus a word gather PER BYTE (~13 gathers/byte); this
    does 2 gathers per 4 bytes."""
    R, W = words.shape
    j = jnp.arange(total_pad, dtype=jnp.int32)
    # unit[j] = #\{u >= 1 : word_offsets[u] <= j\}; collisions (empty
    # units) accumulate correctly through the scatter-add
    mark = jnp.zeros((total_pad,), jnp.int32).at[word_offsets[1:-1]].add(
        1, mode="drop")
    unit = jnp.cumsum(mark)
    pos = j - word_offsets[unit]
    val = jnp.take(words.reshape(-1),
                   jnp.clip(unit * W + pos, 0, R * W - 1))
    return jnp.where(j < word_offsets[-1], val, 0)


@partial(jax.jit, static_argnames=("W",))
def device_expand_words_u32(payload: jnp.ndarray, word_offsets: jnp.ndarray,
                            word_lens: jnp.ndarray, W: int) -> jnp.ndarray:
    """Inverse of device_compact_words: (T,) u32 payload -> (R, W) u32
    zero-padded word streams. One gather per word."""
    R = word_lens.shape[0]
    T = payload.shape[0]
    idx = word_offsets[:R, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    val = jnp.take(payload, jnp.clip(idx, 0, T - 1))
    ok = jnp.arange(W)[None, :] < word_lens[:, None]
    return jnp.where(ok, val, 0)


@partial(jax.jit, static_argnames=("W", "batch"))
def device_expand_words_slices(payload: jnp.ndarray,
                               word_offsets: jnp.ndarray,
                               word_lens: jnp.ndarray, W: int,
                               batch: int = 4) -> jnp.ndarray:
    """device_expand_words_u32 as a scan of dynamic slices instead of
    one (R, W) flat gather: each step DMAs `batch` contiguous W-word
    windows — dense copies instead of per-element gather addressing.
    `batch` rows per step amortize the per-step cost."""
    R = word_lens.shape[0]
    K = batch
    Rp = -(-R // K) * K
    paypad = jnp.concatenate([payload, jnp.zeros((W,), payload.dtype)])
    offs = word_offsets[:R].astype(jnp.int32)
    if Rp != R:
        offs = jnp.concatenate([offs, jnp.zeros((Rp - R,), jnp.int32)])
    iw = jnp.arange(W, dtype=jnp.int32)

    def step(_, r):
        rows = [jax.lax.dynamic_slice(paypad, (offs[r * K + k],), (W,))
                for k in range(K)]
        return None, jnp.stack(rows)

    _, rows = jax.lax.scan(step, None, jnp.arange(Rp // K, dtype=jnp.int32))
    rows = rows.reshape(Rp, W)[:R]
    return jnp.where(iw[None, :] < word_lens[:, None], rows, 0)


@partial(jax.jit, static_argnames=("total_pad", "batch"))
def device_compact_words_slices(words: jnp.ndarray,
                                word_offsets: jnp.ndarray,
                                total_pad: int,
                                batch: int = 16) -> jnp.ndarray:
    """device_compact_words as a scan of dynamic-update-slices in
    ASCENDING unit order: unit r writes its full W-word row at its
    offset; the (W - len) garbage words beyond its true stream are
    overwritten by unit r+1's write at offset[r]+len[r]. The buffer
    carries W slack words so the last unit's garbage lands past
    total_pad. `batch` rows per scan step amortize the per-step cost.
    Bit-identical to device_compact_words
    (tested); zero-padded rows parked at the true total keep the
    ascending-overwrite argument for the R % batch tail."""
    R, W = words.shape
    K = batch
    Rp = -(-R // K) * K
    total = word_offsets[-1]
    offs = word_offsets[:R].astype(jnp.int32)
    if Rp != R:
        offs = jnp.concatenate(
            [offs, jnp.broadcast_to(total.astype(jnp.int32), (Rp - R,))])
        words = jnp.concatenate(
            [words, jnp.zeros((Rp - R, W), words.dtype)])

    def step(buf, r):
        for k in range(K):
            buf = jax.lax.dynamic_update_slice(
                buf, words[r * K + k], (offs[r * K + k],))
        return buf, None

    buf0 = jnp.zeros((total_pad + W,), words.dtype)
    buf, _ = jax.lax.scan(step, buf0, jnp.arange(Rp // K, dtype=jnp.int32))
    j = jnp.arange(total_pad, dtype=jnp.int32)
    return jnp.where(j < total, buf[:total_pad], 0)


_BLK = 128    # words per windowed-gather/scatter slice


@partial(jax.jit, static_argnames=("W",))
def device_expand_words_blocks(payload: jnp.ndarray,
                               word_offsets: jnp.ndarray,
                               word_lens: jnp.ndarray, W: int) -> jnp.ndarray:
    """device_expand_words_u32 via a WINDOWED gather: one 128-word slice
    per (unit, block) instead of one gather element per word — ~100x
    fewer gather rows to address. Bit-identical to
    device_expand_words_u32 (tested)."""
    R = word_lens.shape[0]
    T = payload.shape[0]
    Wb = -(-W // _BLK) * _BLK
    B = Wb // _BLK
    paypad = jnp.concatenate([payload, jnp.zeros((_BLK,), payload.dtype)])
    starts = (word_offsets[:R, None].astype(jnp.int32)
              + jnp.arange(B, dtype=jnp.int32)[None, :] * _BLK)
    starts = jnp.clip(starts, 0, T)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(),
        start_index_map=(0,))
    out = jax.lax.gather(paypad, starts.reshape(-1, 1), dn,
                         slice_sizes=(_BLK,),
                         indices_are_sorted=False,
                         mode=jax.lax.GatherScatterMode.CLIP)
    rows = out.reshape(R, Wb)[:, :W]
    ok = jnp.arange(W)[None, :] < word_lens[:, None]
    return jnp.where(ok, rows, 0)


@partial(jax.jit, static_argnames=("total_pad",))
def device_compact_words_blocks(words: jnp.ndarray,
                                word_offsets: jnp.ndarray,
                                total_pad: int) -> jnp.ndarray:
    """device_compact_words via a WINDOWED scatter: each unit's FULL
    128-word blocks land as slice updates (provably disjoint across
    units: block b of unit r covers [off_r + 128b, off_r + 128(b+1)) ⊂
    [off_r, off_r + len_r)), and the <=127-word ragged tails go through
    a small per-element scatter (~2% of the words). Bit-identical to
    device_compact_words (tested)."""
    R, W = words.shape
    wl = (word_offsets[1:] - word_offsets[:-1]).astype(jnp.int32)
    total = word_offsets[-1]
    Wb = -(-W // _BLK) * _BLK
    if Wb != W:
        words = jnp.pad(words, ((0, 0), (0, Wb - W)))
    B = Wb // _BLK
    full = wl // _BLK                                   # (R,)
    offs = word_offsets[:R].astype(jnp.int32)
    starts = offs[:, None] + jnp.arange(B, dtype=jnp.int32)[None, :] * _BLK
    validb = jnp.arange(B, dtype=jnp.int32)[None, :] < full[:, None]
    # dump PAST the buffer end so FILL_OR_DROP / mode='drop' actually
    # discards invalid blocks/elements — every invalid row maps to the
    # same index, so an in-bounds dump would violate unique_indices=True
    # (XLA declares duplicate indices UB under that flag; ADVICE r3)
    dump = jnp.int32(total_pad + 2 * _BLK)
    starts = jnp.where(validb, starts, dump)
    buf = jnp.zeros((total_pad + 2 * _BLK,), words.dtype)
    dn = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0,))
    buf = jax.lax.scatter(
        buf, starts.reshape(-1, 1),
        words.reshape(R, B, _BLK).reshape(R * B, _BLK), dn,
        indices_are_sorted=False, unique_indices=True,
        mode=jax.lax.GatherScatterMode.FILL_OR_DROP)
    # ragged tails: one 128-word slice per unit gathered from the row,
    # then element-scattered (disjoint from every full block)
    tail_src_start = (jnp.arange(R, dtype=jnp.int32) * Wb + full * _BLK)
    gdn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(),
        start_index_map=(0,))
    wflat = jnp.concatenate(
        [words.reshape(-1), jnp.zeros((_BLK,), words.dtype)])
    tsrc = jax.lax.gather(wflat, tail_src_start[:, None], gdn,
                          slice_sizes=(_BLK,),
                          mode=jax.lax.GatherScatterMode.CLIP)  # (R, 128)
    tail_len = wl - full * _BLK
    tpos = (offs + full * _BLK)[:, None] \
        + jnp.arange(_BLK, dtype=jnp.int32)[None, :]
    tvalid = jnp.arange(_BLK, dtype=jnp.int32)[None, :] < tail_len[:, None]
    buf = buf.at[jnp.where(tvalid, tpos, dump).reshape(-1)].set(
        tsrc.reshape(-1), mode="drop", unique_indices=True)
    j = jnp.arange(total_pad, dtype=jnp.int32)
    return jnp.where(j < total, buf[:total_pad], 0)


@partial(jax.jit, static_argnames=("total_pad",))
def device_compact_payload(words: jnp.ndarray, offsets: jnp.ndarray,
                           total_pad: int) -> jnp.ndarray:
    """words (R, W) uint32 + byte offsets (R+1,) -> (total_pad,) uint8
    dense payload (positions past offsets[-1] are zero)."""
    j = jnp.arange(total_pad)
    unit = jnp.searchsorted(offsets, j, side="right") - 1
    unit = jnp.clip(unit, 0, words.shape[0] - 1)
    pos = j - offsets[unit]
    word = words[unit, jnp.clip(pos >> 2, 0, words.shape[1] - 1)]
    byte = (word >> (8 * (3 - (pos & 3))).astype(jnp.uint32)) & 0xFF
    valid = j < offsets[-1]
    return jnp.where(valid, byte, 0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("W",))
def device_expand_words(payload: jnp.ndarray, offsets: jnp.ndarray,
                        byte_lens: jnp.ndarray, W: int) -> jnp.ndarray:
    """Inverse of device_compact_payload: (T,) uint8 payload -> (R, W)
    uint32 zero-padded word streams."""
    R = byte_lens.shape[0]
    T = payload.shape[0]
    base = offsets[:R, None] + 4 * jnp.arange(W)[None, :]
    word = jnp.zeros((R, W), jnp.uint32)
    for k in range(4):
        bidx = base + k
        b = payload[jnp.clip(bidx, 0, T - 1)].astype(jnp.uint32)
        ok = (4 * jnp.arange(W)[None, :] + k) < byte_lens[:, None]
        word = word | jnp.where(ok, b, 0) << jnp.uint32(8 * (3 - k))
    return word


# ---------------------------------------------------------------------------
# host-side (numpy) byte/word marshalling
# ---------------------------------------------------------------------------

def words_to_block_bytes(words: np.ndarray, bit_lengths: np.ndarray):
    """Slice each block's big-endian byte stream to its used length.

    words: (B, W) uint32 (host), bit_lengths: (B,) -> list of bytes objects.
    """
    raw = np.ascontiguousarray(words.astype('>u4')).view(np.uint8)
    raw = raw.reshape(words.shape[0], -1)
    nbytes = (np.asarray(bit_lengths).astype(np.int64) + 7) // 8
    return [raw[i, : nbytes[i]].tobytes() for i in range(words.shape[0])]


def words_to_payload(words: np.ndarray, bit_lengths: np.ndarray,
                     aligned: bool = False) -> bytes:
    """Concatenate every unit's stream — at exact byte lengths, or at
    4-byte-aligned offsets when `aligned` (the FLAG_ALIGNED_PAYLOAD
    layout; native threaded memcpy via utils/native.py)."""
    from ..utils import native
    raw = np.ascontiguousarray(words.astype('>u4')).view(np.uint8)
    raw = raw.reshape(words.shape[0], -1)
    bits = np.asarray(bit_lengths).astype(np.int64)
    nbytes = ((bits + 31) // 32) * 4 if aligned else (bits + 7) // 8
    return native.join_rows(raw, nbytes)


def block_bytes_to_words(blocks, W: int) -> np.ndarray:
    """Inverse of words_to_block_bytes: pad byte blocks into (B, W) uint32."""
    B = len(blocks)
    out = np.zeros((B, W * 4), dtype=np.uint8)
    for i, blk in enumerate(blocks):
        a = np.frombuffer(blk, dtype=np.uint8)
        out[i, : a.size] = a
    return out.view('>u4').astype(np.uint32).reshape(B, W)
