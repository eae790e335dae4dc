"""Hybrid host/device executor: split the unit batch between the device
stream and host threads.

The container format makes every decode-unit stream independent, so WHO
encodes/decodes a unit is invisible in the artifact: the native C++ unit
codec (native/mhc_codec.cpp) is bit-identical to the device kernels by
construction, and this module proves it by producing containers
byte-identical to `api.compress` at any split fraction (tested,
tests/test_hybrid.py).

Why split: the host link and the device are independent resources; the
split hides h2d/d2h latency behind host compute. The global histogram is
still exact: device part + host part (threaded C++) are summed before
the single deterministic table build (SURVEY.md §3.1 two-pass contract).

host_fraction: share of units encoded/decoded by host threads
(default MHC_HOST_FRACTION env or 0.5). 0.0 = pure device,
1.0 = pure host (a complete native CPU codec — useful without a GPU).
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np

from . import api, container, engine
from .models.entropy import get_model
from .ops import bitpack
from .utils import native


def _fraction(host_fraction: float | None) -> float:
    if host_fraction is None:
        host_fraction = float(os.environ.get("MHC_HOST_FRACTION", "0.5"))
    return min(max(host_fraction, 0.0), 1.0)


def _device_units(R: int, host_fraction: float) -> int:
    """Device takes the unit prefix [0, S); host threads take the tail."""
    return R - int(round(R * host_fraction))


def _host_encode(host_bytes: np.ndarray, du: int, lengths: np.ndarray,
                 markov: bool, raw_mode: int):
    packed = native.build_enc_table(lengths)
    row_stride = bitpack.words_for_block(du) * 4
    return native.encode_units(host_bytes, du, packed, markov, row_stride,
                               raw_mode=raw_mode)


def compress(data: bytes, mode: str = "markov",
             block_size: int = api.DEFAULT_BLOCK_SIZE,
             decode_unit: int | None = None, crc: bool = True,
             host_fraction: float | None = None,
             hist_method: str | None = None,
             pack_method: str | None = None) -> bytes:
    """Container-identical to api.compress(data, mode, block_size,
    decode_unit, crc) — the split is an execution detail."""
    if not native.available():
        return api.compress(data, mode=mode, block_size=block_size,
                            crc=crc, decode_unit=decode_unit)
    model = get_model(mode)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    n = len(data)
    R = (n + du - 1) // du
    if R == 0:
        return api.compress(data, mode=mode, block_size=block_size,
                            crc=crc, decode_unit=du)
    S = _device_units(R, _fraction(host_fraction))
    split = S * du
    host_bytes = np.frombuffer(data, np.uint8)[split:]

    # pass 1: global histogram — device prefix (async dispatch) + host
    # tail (C++ threads) overlap, then one deterministic table build
    st = engine.stage(data[:split], mode=mode, block_size=block_size,
                      decode_unit=du) if split else None
    counts_dev = None
    if st is not None:
        hm = hist_method or api._default_hist_method()
        for ud, nvd in zip(st.units, st.n_valid):
            c = model.histogram(ud, nvd, method=hm)
            counts_dev = c if counts_dev is None else counts_dev + c
        counts_dev.copy_to_host_async()
    if host_bytes.size:
        counts_host = (native.hist_markov(host_bytes, du) if model.markov
                       else native.hist_order0(host_bytes))
    else:
        counts_host = 0
    counts = counts_host + (np.asarray(counts_dev).astype(np.int64)
                            if counts_dev is not None else 0)
    lengths = model.lengths_from_counts(counts)
    lengths_host = np.asarray(lengths, dtype=np.uint8)

    # pass 2: emit — host threads run concurrently with the device stream
    raw_mode = 0 if du == block_size else (
        2 if container.aligned_payload(model.mode) else 1)
    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(_host_encode, host_bytes, du, lengths_host,
                         model.markov, raw_mode)
               if host_bytes.size else None)
        enc_dev = (engine.encode(st, pack_method=pack_method,
                                 lengths=lengths) if st is not None
                   else None)
        rows, bits_host = fut.result() if fut is not None else \
            (np.zeros((0, 4), np.uint8), np.zeros((0,), np.int64))

    payload = (engine.fetch_payload(enc_dev) if enc_dev is not None
               else b"") + native.join_rows(
                   rows, container.stream_byte_lens(bits_host, model.mode))
    bit_lens = np.concatenate(
        [enc_dev.bit_lens if enc_dev is not None
         else np.zeros((0,), np.int64), bits_host])
    checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    return container.build_container(
        model.mode, n, block_size, lengths_host, bit_lens, payload,
        checksum, decode_unit=du)


def _host_decode(blob: bytes, meta, S: int, du: int,
                 starts: np.ndarray) -> bytes:
    byte_lens = meta.byte_lengths[S:].astype(np.int64)
    n_local = meta.orig_len - S * du
    total = int(byte_lens.sum())
    payload = np.frombuffer(blob, np.uint8, count=total,
                            offset=meta.payload_off + int(starts[S]))
    offsets = (starts[S:-1] - starts[S]).astype(np.int64)
    lut = native.build_dec_lut(meta.lengths)
    markov = meta.mode == container.MODE_MARKOV
    out = np.empty(n_local, np.uint8)
    raw_mode = 0
    if meta.flags & container.FLAG_RAW_UNITS:
        raw_mode = 2 if meta.flags & container.FLAG_ALIGNED_PAYLOAD else 1
    native.decode_units(payload, offsets, byte_lens, du, n_local, lut,
                        markov, out, raw_mode=raw_mode)
    return out.tobytes()


def _device_result_from_container(blob: bytes, meta, S: int, du: int,
                                  starts: np.ndarray) -> engine.EncodeResult:
    """Stage the device prefix's payload into HBM as an EncodeResult so
    engine.decode can run it."""
    model = get_model(meta.mode)
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    byte_lens = meta.byte_lengths[:S].astype(np.int64)
    C = min(api._chunk_units(du), S)
    payload, payload_n = [], []
    for lo in range(0, S, C):
        hi = min(lo + C, S)
        total_b = int(byte_lens[lo:hi].sum())
        raw = np.frombuffer(blob, np.uint8, count=total_b,
                            offset=meta.payload_off + int(starts[lo]))
        if aligned:
            total = total_b // 4
            pad = max(-(-total // (1 << 18)) << 18, 1 << 18)
            flat = np.zeros(pad, np.uint32)
            flat[:total] = raw.copy().view(">u4")
        else:
            total = total_b
            pad = max(-(-total // (1 << 20)) << 20, 1 << 20)
            flat = np.zeros(pad, np.uint8)
            flat[:total] = raw
        payload.append(jnp.asarray(flat))
        payload_n.append(total)
    return engine.EncodeResult(
        mode=model.name, block_size=meta.block_size, decode_unit=du,
        orig_len=min(S * du, meta.orig_len), n_units=S, chunk=C,
        lengths=meta.lengths, byte_lens=byte_lens,
        bit_lens=byte_lens * 8, payload=payload, payload_n=payload_n,
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        payload_aligned=aligned)


def decompress(blob: bytes, verify: bool = True,
               host_fraction: float | None = None,
               decode_method: str | None = None) -> bytes:
    if not native.available():
        return api.decompress(blob, verify=verify,
                              decode_method=decode_method)
    meta = container.parse_container(blob)
    if meta.orig_len == 0:
        return b""
    du = meta.decode_unit or meta.block_size
    R = len(meta.byte_lengths)
    S = _device_units(R, _fraction(host_fraction))
    starts = np.zeros(R + 1, np.int64)
    np.cumsum(meta.byte_lengths.astype(np.int64), out=starts[1:])

    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(_host_decode, blob, meta, S, du, starts)
               if S < R else None)
        if S > 0:
            enc = _device_result_from_container(blob, meta, S, du, starts)
            outs = engine.decode(enc, decode_method=decode_method)
            dev_bytes = engine.fetch_bytes(enc, outs)
        else:
            dev_bytes = b""
        host_part = fut.result() if fut is not None else b""
    data = dev_bytes + host_part
    if verify:
        container.verify_crc(data, meta)
    return data
