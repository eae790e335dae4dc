"""Ragged copy variants and the step-major lookup.

Differential contracts (all bit-exact):
  * batched-slice / windowed-block expand+compact == the flat-gather
    forms — these feed the engine payload layout, where any divergence
    silently corrupts containers.
  * the step-major lookup (lookup_cl_sm) == lookup_cl_t.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp

from mhc.ops import bitpack


def _ragged_words(rng, R, W):
    wl = rng.integers(0, W + 1, size=R).astype(np.int32)
    words = np.zeros((R, W), np.uint32)
    for r in range(R):
        words[r, :wl[r]] = rng.integers(0, 1 << 32, size=wl[r],
                                        dtype=np.uint32)
    offs = np.zeros(R + 1, np.int32)
    np.cumsum(wl, out=offs[1:])
    return words, wl, offs


@pytest.mark.parametrize("R,W,seed", [(70, 96, 2), (33, 300, 4)])
def test_copy_variants_bit_identical(R, W, seed):
    rng = np.random.default_rng(seed)
    words, wl, offs = _ragged_words(rng, R, W)
    total = int(offs[-1])
    tp = max(-(-total // 256) * 256, 256)
    ref = np.asarray(bitpack.device_compact_words(
        jnp.asarray(words), jnp.asarray(offs), tp))
    for fn in (bitpack.device_compact_words_slices,
               bitpack.device_compact_words_blocks):
        out = np.asarray(fn(jnp.asarray(words), jnp.asarray(offs), tp))
        assert np.array_equal(ref, out), fn.__name__
    eref = np.asarray(bitpack.device_expand_words_u32(
        jnp.asarray(ref), jnp.asarray(offs), jnp.asarray(wl), W))
    for fn in (bitpack.device_expand_words_slices,
               bitpack.device_expand_words_blocks):
        out = np.asarray(fn(jnp.asarray(ref), jnp.asarray(offs),
                            jnp.asarray(wl), W))
        assert np.array_equal(eref, out), fn.__name__


def test_lookup_cl_sm_matches_t():
    """Step-major (pre-transposed) lookup must equal lookup_cl_t on the
    unit-major batch."""
    from mhc import api
    from mhc.models.entropy import get_model
    rng = np.random.default_rng(21)
    units = rng.integers(0, 256, (64, 1024), dtype=np.uint8)
    units[units < 128] %= 23
    nv = np.full((64,), 1024, np.int32)
    nv[-1] = 517
    model = get_model("markov")
    counts = model.histogram(jnp.asarray(units), jnp.asarray(nv),
                             method="scatter")
    tables = model.tables_from_lengths(
        model.lengths_from_counts(np.asarray(counts)))
    ref = np.asarray(api.lookup_cl_t(jnp.asarray(units), jnp.asarray(nv),
                                     tables))
    got = np.asarray(api.lookup_cl_sm(
        jnp.asarray(np.ascontiguousarray(units.T)), jnp.asarray(nv),
        tables))
    assert (ref == got).all()
