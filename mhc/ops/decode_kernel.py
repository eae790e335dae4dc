"""Symbol decode as one GPU kernel (Pallas, lowered through Triton).

`bitpack.decode_blocks` is the reference: a `lax.scan` with one step per
symbol, each step a few (B,)-wide gathers. On a GPU every step of that
scan is its own handful of kernel launches, so its time grows with the
number of steps, not with bytes. This kernel moves the symbol loop inside
one launch:

* one program per LANES unit streams, one stream per lane (a warp);
* the loop over `n_out` symbols runs inside the kernel;
* each lane keeps three consecutive stream words in registers (the two
  the MAX_CODE_LEN-bit window straddles plus one prefetched), so a word
  load is issued one symbol before it can be needed;
* the canonical tables (limits, base - first_code, sorted symbols as
  uint8, 96 KB for 256 contexts) are read with per-lane gathers that
  the L1/L2 caches serve;
* four symbols are packed into one uint32 before each store.

The output is byte-identical to `bitpack.decode_blocks` (positions past
a unit's `n_valid` are 0). Order-0 is the one-table case: every lane
reads context row 0.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .huffman import MAX_CODE_LEN

# Unit streams per program. One warp of 32 lanes per program measured
# fastest on an H100 (one stream per thread; wider programs put several
# warps on fewer SMs and lose).
LANES = 32
NUM_WARPS = 1
_ROW = MAX_CODE_LEN + 1          # table row stride (lim/base/first_code)
_NEVER = 0xFFFFFFFF              # limit no window reaches


def _decode_kernel(words_ref, nv_ref, lim_ref, bf_ref, syms_ref, out_ref,
                   *, n_out: int, W: int, markov: bool, init_ctx: int):
    row = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    nv = nv_ref[row]
    wbase = row * W
    zero = jnp.zeros((LANES,), jnp.int32)

    def word(k):
        return words_ref[wbase + jnp.minimum(k, W - 1)]

    def body(t4, carry):
        pos, cur, nxt, nn, prev = carry
        packed = jnp.zeros((LANES,), jnp.uint32)
        for k in range(4):
            s = pos & 31
            hi = cur << s
            lo = jnp.where(s == 0, jnp.uint32(0), nxt >> ((32 - s) & 31))
            window = (hi | lo) >> (32 - MAX_CODE_LEN)
            ctx = prev if markov else zero
            trow = ctx * _ROW
            # length = 1 + #{l : window >= lim[ctx, l]}; columns 0 and
            # MAX_CODE_LEN hold a limit no window reaches
            length = jnp.ones((LANES,), jnp.int32)
            for col in range(1, MAX_CODE_LEN):
                length += (window >= lim_ref[trow + col]).astype(jnp.int32)
            code = (window >> (MAX_CODE_LEN - length).astype(jnp.uint32)
                    ).astype(jnp.int32)
            rank = jnp.clip(bf_ref[trow + length] + code, 0, 255)
            sym = syms_ref[ctx * 256 + rank].astype(jnp.int32)

            valid = t4 * 4 + k < nv
            adv = jnp.where(valid, length, 0).astype(jnp.uint32)
            crossed = s + adv >= 32
            pos = pos + adv
            cur = jnp.where(crossed, nxt, cur)
            nxt = jnp.where(crossed, nn, nxt)
            nn = word((pos >> 5).astype(jnp.int32) + 2)
            prev = jnp.where(valid, sym, prev)
            packed |= jnp.where(valid, sym, 0).astype(jnp.uint32) << (8 * k)
        out_ref[row * (n_out // 4) + t4] = packed
        return pos, cur, nxt, nn, prev

    carry = (jnp.zeros((LANES,), jnp.uint32), word(zero), word(zero + 1),
             word(zero + 2), zero + init_ctx)
    jax.lax.fori_loop(0, n_out // 4, body, carry)


@partial(jax.jit, static_argnames=("n_out", "markov", "init_ctx",
                                   "interpret"))
def decode_blocks_kernel(words: jnp.ndarray, n_valid: jnp.ndarray,
                         lim: jnp.ndarray, base: jnp.ndarray,
                         first_code: jnp.ndarray, sorted_syms: jnp.ndarray,
                         n_out: int, markov: bool = True, init_ctx: int = 0,
                         interpret: bool = False) -> jnp.ndarray:
    """Drop-in for `bitpack.decode_blocks` (same arguments and output).

    words (B, W) uint32, n_valid (B,) int32, tables as built by
    `canonical.canonical_codes` in the unified (256, ...) layout.
    Returns (B, n_out) uint8. B is padded to a multiple of LANES with
    empty streams and n_out to a multiple of 4 (the kernel stores four
    symbols per word).
    """
    B, W = words.shape
    if B == 0:
        return jnp.zeros((0, n_out), jnp.uint8)
    Bp = -(-B // LANES) * LANES
    if Bp != B:
        words = jnp.pad(words, ((0, Bp - B), (0, 0)))
        n_valid = jnp.pad(n_valid, (0, Bp - B))
    lim_p = (lim.astype(jnp.uint32).at[:, 0].set(_NEVER)
             .at[:, MAX_CODE_LEN].set(_NEVER).reshape(-1))
    bf = (base.astype(jnp.int32) - first_code.astype(jnp.int32)).reshape(-1)
    syms = sorted_syms.astype(jnp.uint8).reshape(-1)
    n4 = -(-n_out // 4) * 4
    kernel = partial(_decode_kernel, n_out=n4, W=W, markov=markov,
                     init_ctx=init_ctx)
    out = pl.pallas_call(
        kernel,
        grid=(Bp // LANES,),
        out_shape=jax.ShapeDtypeStruct((Bp * (n4 // 4),), jnp.uint32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="mhc_symbol_decode",
    )(words.reshape(-1), n_valid.astype(jnp.int32), lim_p, bf, syms)
    # 4 symbols per uint32, first symbol in the low byte
    out = jax.lax.bitcast_convert_type(out.reshape(Bp, n4 // 4), jnp.uint8)
    return out.reshape(Bp, n4)[:B, :n_out]
