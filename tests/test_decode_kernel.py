"""The GPU symbol-decode kernel (ops/decode_kernel.py) against its plain
reference, `bitpack.decode_blocks` (the XLA scan), in Pallas interpret
mode on the CPU: byte-identical output for both modes, any `n_out`, any
batch size, ragged and empty rows, every code length, one-symbol
contexts, a non-zero initial context and garbage streams; plus the
wrapper's padding and the drivers' use of the kernel."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from mhc import api, engine
from mhc.models.entropy import get_model
from mhc.ops import bitpack
from mhc.ops import decode_kernel
from mhc.ops.decode_kernel import LANES, decode_blocks_kernel
from mhc.ops.huffman import MAX_CODE_LEN
from tests.corpus import english_like, mixed_binary

MODES = ["markov", "huffman"]


def _tables(model, units, nv):
    counts = model.histogram(jnp.asarray(units), jnp.asarray(nv),
                             method="scatter")
    return model.tables_from_lengths(
        model.lengths_from_counts(np.asarray(counts)))


def _check(units, nv, tables, markov, n_out, init_ctx=0):
    """Encode `units` with `tables`, decode with the kernel (interpret)
    and the scan; assert identical bytes and a bit-exact roundtrip."""
    words, _ = bitpack.encode_blocks(
        jnp.asarray(units), jnp.asarray(nv), tables["codes"],
        tables["lengths"], init_ctx=init_ctx)
    args = (words, jnp.asarray(nv), tables["lim"], tables["base"],
            tables["first_code"], tables["sorted_syms"])
    ref = np.asarray(bitpack.decode_blocks(
        *args, n_out=n_out, markov=markov, init_ctx=init_ctx))
    got = np.asarray(decode_blocks_kernel(
        *args, n_out=n_out, markov=markov, init_ctx=init_ctx,
        interpret=True))
    assert got.shape == ref.shape == (units.shape[0], n_out)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    pos = np.arange(n_out)[None, :]
    np.testing.assert_array_equal(
        np.where(pos < np.asarray(nv)[:, None], units[:, :n_out], 0), got)
    return got


def _units(data: bytes, n_out: int, rows: int):
    units, nv = api.blockify(data[: rows * n_out], n_out)
    return units, nv


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_out", [16, 64, 256])
@pytest.mark.parametrize("rows", [2 * LANES, LANES + 5])
def test_kernel_matches_scan(mode, n_out, rows):
    model = get_model(mode)
    units, nv = _units(mixed_binary(rows * n_out, seed=n_out), n_out, rows)
    _check(units, nv, _tables(model, units, nv), model.markov, n_out)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_ragged_and_empty_rows(mode):
    model = get_model(mode)
    n_out = 128
    units, nv = _units(english_like(40 * n_out, seed=3), n_out, 40)
    nv = nv.copy()
    nv[[1, 7, 33]] = 0
    nv[[2, 8, 39]] = [1, 37, 127]
    units[np.arange(n_out)[None, :] >= nv[:, None]] = 0
    _check(units, nv, _tables(model, units, nv), model.markov, n_out)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_every_code_length(mode):
    """Geometric frequencies give codes of every length up to
    MAX_CODE_LEN; uniform draws over the alphabet keep long codes
    frequent in the decoded streams."""
    model = get_model(mode)
    geo = np.array([1 << max(20 - i, 0) if i < 22 else 0
                    for i in range(256)], np.int64)
    if model.markov:
        counts = np.stack([np.roll(geo, c % 7) for c in range(256)])
    else:
        counts = geo
    lengths = np.asarray(model.lengths_from_counts(counts))
    assert lengths.max() == MAX_CODE_LEN
    tables = model.tables_from_lengths(lengths)
    rng = np.random.default_rng(7)
    n_out = 96
    units = rng.integers(0, 22, (LANES + 3, n_out), dtype=np.uint8)
    if model.markov:   # stay inside each context's alphabet
        for t in range(1, n_out):
            units[:, t] = units[:, t] % 21 + units[:, t - 1] % 7
        units[:, 0] %= 21
    nv = np.full(units.shape[0], n_out, np.int32)
    _check(units, nv, tables, model.markov, n_out)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_one_symbol_contexts(mode):
    """Contexts (or an alphabet) with a single symbol: 1-bit codes."""
    model = get_model(mode)
    n_out = 64
    if model.markov:
        data = (b"qu" * 7 + b"the quick brown fox ") * 200
    else:
        data = b"\x07" * (LANES * n_out)
    units, nv = _units(data, n_out, LANES)
    _check(units, nv, _tables(model, units, nv), model.markov, n_out)


@pytest.mark.parametrize("init_ctx", [0, 97, 255])
def test_kernel_init_ctx(init_ctx):
    from mhc.ops import histogram
    model = get_model("markov")
    n_out = 64
    units, nv = _units(english_like(LANES * n_out, seed=9), n_out, LANES)
    counts = histogram.histogram_markov(
        jnp.asarray(units), jnp.asarray(nv), init_ctx=init_ctx,
        method="scatter")
    tables = model.tables_from_lengths(
        model.lengths_from_counts(np.asarray(counts)))
    _check(units, nv, tables, True, n_out, init_ctx=init_ctx)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_garbage_streams_match_scan(mode):
    """Random words (as literal units present them to the decoder): the
    kernel must follow the scan exactly and never read out of bounds."""
    model = get_model(mode)
    units, nv = _units(english_like(LANES * 64, seed=2), 64, LANES)
    t = _tables(model, units, nv)
    rng = np.random.default_rng(11)
    words = jnp.asarray(rng.integers(0, 1 << 32, (LANES + 1, 9),
                                     dtype=np.uint32))
    nvd = jnp.full((LANES + 1,), 64, jnp.int32)
    args = (words, nvd, t["lim"], t["base"], t["first_code"],
            t["sorted_syms"])
    ref = bitpack.decode_blocks(*args, n_out=64, markov=model.markov)
    got = decode_blocks_kernel(*args, n_out=64, markov=model.markov,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("rows,n_out", [(1, 30), (LANES, 64),
                                        (LANES + 1, 33)])
def test_wrapper_pads_rows_and_n_out(rows, n_out):
    """B is padded to whole programs and n_out to whole output words;
    the caller sees exactly (B, n_out)."""
    model = get_model("markov")
    units, nv = _units(english_like(rows * n_out, seed=rows), n_out, rows)
    _check(units, nv, _tables(model, units, nv), True, n_out)


def test_wrapper_empty_batch():
    t = get_model("huffman").tables_from_lengths(np.full(256, 8, np.int32))
    out = decode_blocks_kernel(
        jnp.zeros((0, 4), jnp.uint32), jnp.zeros((0,), jnp.int32),
        t["lim"], t["base"], t["first_code"], t["sorted_syms"], n_out=16,
        interpret=True)
    assert out.shape == (0, 16) and out.dtype == jnp.uint8


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the drivers' 'pallas' decoder through interpret mode."""
    monkeypatch.setattr(
        decode_kernel, "decode_blocks_kernel",
        functools.partial(decode_kernel.decode_blocks_kernel,
                          interpret=True))


@pytest.mark.parametrize("mode", MODES)
def test_api_decompress_with_kernel(interpret_kernel, mode):
    data = mixed_binary(150_000, seed=31)
    blob = api.compress(data, mode=mode, block_size=4096)
    assert api.decompress(blob, decode_method="pallas") == data


@pytest.mark.parametrize("mode", MODES)
def test_engine_decode_with_kernel(mode):
    data = mixed_binary(120_000, seed=32)
    st = engine.stage(data, mode=mode, block_size=4096, chunk_units=16)
    enc = engine.encode(st)
    outs = engine.decode(enc, decode_method="pallas", interpret=True)
    assert engine.fetch_bytes(enc, outs) == data


def test_unknown_decode_method_raises():
    with pytest.raises(ValueError, match="unknown decode method"):
        api.decode_fn("mosaic")


def test_unknown_pack_method_raises():
    with pytest.raises(ValueError, match="unknown pack method"):
        api._packer("dense")
