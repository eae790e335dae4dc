"""Context-conditioned byte histograms.

Capability parity: reference hot loop 1 — `counts[prev][cur]++` over the
input, single thread (SURVEY.md §3.1; mount empty, §0). Two batched
forms: a scatter-add into the 65,536 bins, and the matmul form — with
A = onehot(prev) and Bm = onehot(cur) (N x 256 each), counts = A^T @ Bm
on the tensor cores. Chunked accumulation (chunk <= 2^17 rows) keeps
every f32 partial count an exact integer before the int32 reduction.

Block semantics: the Markov context resets to `init_ctx` at every block
start, matching the block-parallel encoder (`bitpack.py`), so histograms
computed here correspond exactly to the code streams emitted later.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_CHUNK = 1 << 17  # rows per matmul chunk; per-cell partial <= 2^17 << 2^24


def markov_pairs(data: jnp.ndarray, n_valid: jnp.ndarray, init_ctx: int = 0):
    """(prev, cur, valid) flattened over a (B, n) block batch."""
    data = data.astype(jnp.int32)
    B, n = data.shape
    prev = jnp.concatenate(
        [jnp.full((B, 1), init_ctx, jnp.int32), data[:, :-1]], axis=1)
    valid = jnp.arange(n)[None, :] < n_valid[:, None]
    return prev.reshape(-1), data.reshape(-1), valid.reshape(-1)


@partial(jax.jit, static_argnames=("method",))
def histogram_markov(data: jnp.ndarray, n_valid: jnp.ndarray,
                     init_ctx: int = 0, method: str = "matmul") -> jnp.ndarray:
    """256x256 [prev, cur] counts over a (B, n) block batch. int32.

    method: 'matmul' (chunked one-hot matmul) or 'scatter'
    (scatter-add). Both produce identical counts (tested)."""
    prev, cur, valid = markov_pairs(data, n_valid, init_ctx)
    if method == "scatter":
        upd = valid.astype(jnp.int32)
        return jnp.zeros((256, 256), jnp.int32).at[prev, cur].add(upd)
    return _matmul_hist(prev, cur, valid)


def _matmul_hist(prev, cur, valid):
    N = prev.shape[0]
    C = min(_CHUNK, max(N, 1))
    pad = (-N) % C
    if pad:
        prev = jnp.concatenate([prev, jnp.zeros((pad,), jnp.int32)])
        cur = jnp.concatenate([cur, jnp.zeros((pad,), jnp.int32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    prev = prev.reshape(-1, C)
    cur = cur.reshape(-1, C)
    valid = valid.reshape(-1, C)

    # bf16 one-hots with f32 accumulation: exact, since a chunk's partial
    # count is at most 2^17 < 2^24
    def chunk_step(acc, args):
        p, c, v = args
        a = jax.nn.one_hot(p, 256, dtype=jnp.bfloat16) \
            * v[:, None].astype(jnp.bfloat16)
        bm = jax.nn.one_hot(c, 256, dtype=jnp.bfloat16)
        partial_counts = jax.lax.dot_general(
            a, bm, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return acc + partial_counts.astype(jnp.int32), None

    acc0 = jnp.zeros((256, 256), jnp.int32)
    acc, _ = jax.lax.scan(chunk_step, acc0, (prev, cur, valid))
    return acc


@partial(jax.jit, static_argnames=("method",))
def histogram_order0(data: jnp.ndarray, n_valid: jnp.ndarray,
                     method: str = "matmul") -> jnp.ndarray:
    """(256,) byte counts over a (B, n) block batch. int32."""
    flat = data.astype(jnp.int32).reshape(-1)
    B, n = data.shape
    valid = (jnp.arange(n)[None, :] < n_valid[:, None]).reshape(-1)
    if method == "scatter":
        return jnp.zeros((256,), jnp.int32).at[flat].add(valid.astype(jnp.int32))
    N = flat.shape[0]
    C = min(_CHUNK, max(N, 1))
    pad = (-N) % C
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), jnp.int32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    flat = flat.reshape(-1, C)
    valid = valid.reshape(-1, C)

    def chunk_step(acc, args):
        c, v = args
        oh = jax.nn.one_hot(c, 256, dtype=jnp.float32) * v[:, None]
        return acc + jnp.sum(oh, axis=0).astype(jnp.int32), None

    acc, _ = jax.lax.scan(chunk_step, jnp.zeros((256,), jnp.int32),
                          (flat, valid))
    return acc
