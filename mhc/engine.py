"""Device-resident codec engine: encode/decode with HBM-resident buffers.

The container path (api.py) crosses the host<->device link at every
stage. This engine is the device-rate surface: input blocks, compressed
payload, and decoded output all live in device memory, and the only host
traffic is the table header and the per-unit length index (KBs). It is
the basis for the "encode+decode GB/s per device" metric (BASELINE.json:2
— the C++ oracle it is compared against is likewise RAM-resident,
SURVEY.md §6) and a real API for on-device pipelines (e.g. compressing
tensors that are already on the device).

The compressed artifact is exactly the container payload: the dense
concatenation of byte-aligned unit streams plus the per-unit byte-length
index. `assemble_container()` turns an EncodeResult into a container
byte-identical to `api.compress` (tested).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import api, container
from .models.entropy import get_model
from .ops import bitpack


@dataclass
class Staged:
    """Input block batch staged into HBM (one array per chunk)."""
    mode: str
    block_size: int
    decode_unit: int
    orig_len: int
    n_units: int                 # true unit count (last chunk may pad)
    chunk: int                   # units per chunk
    units: list                  # [(C, du) uint8 device]
    n_valid: list                # [(C,) int32 device]


@dataclass
class EncodeResult:
    mode: str
    block_size: int
    decode_unit: int
    orig_len: int
    n_units: int
    chunk: int
    lengths: np.ndarray          # host code-length header (uint8)
    byte_lens: np.ndarray        # host (n_units,) int64 (layout-aware)
    bit_lens: np.ndarray         # host (n_units,) int64
    payload: list                # per-chunk device payload (see
                                 # payload_aligned)
    payload_n: list              # true element count per chunk
    # True when literal (raw) units may be present (round 5 — engine
    # encodes always substitute; hybrid container staging mirrors the
    # container's FLAG_RAW_UNITS so pre-round-5 files decode unchanged)
    raw_units: bool = True
    # True (engine.encode, round 4): payload chunks are u32 word arrays
    # with every unit stream word-aligned — INDEPENDENT of the container
    # layout (order-0's unaligned container is produced on the HOST at
    # assembly; the round-3 engine byte-compacted order-0 on device via
    # the per-byte searchsorted path at ~10x the cost). False only for
    # hybrid-staged unaligned container prefixes (u8 byte payload).
    payload_aligned: bool = True


def stage(data: bytes, mode: str = "markov",
          block_size: int = api.DEFAULT_BLOCK_SIZE,
          decode_unit: int | None = None,
          chunk_units: int | None = None) -> Staged:
    """Blockify + transfer the input into device memory. NOT part of
    codec time."""
    model = get_model(mode)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    units, n_valid = api.blockify(data, du)
    R = units.shape[0]
    C = min(chunk_units or api._chunk_units(du), max(R, 1))
    devs, nvs = [], []
    for lo in range(0, R, C):
        devs.append(jax.device_put(api._pad_rows(units[lo:lo + C], C)))
        nvs.append(jax.device_put(api._pad_rows(n_valid[lo:lo + C], C)))
    jax.block_until_ready(devs)
    return Staged(mode=model.name, block_size=block_size, decode_unit=du,
                  orig_len=len(data), n_units=R, chunk=C,
                  units=devs, n_valid=nvs)


def histogram(st: Staged, hist_method: str | None = None) -> np.ndarray:
    """Device histogram over the staged units, fetched to host (int64)."""
    model = get_model(st.mode)
    hist_method = hist_method or api._default_hist_method()
    counts = api._histogram(model, zip(st.units, st.n_valid), hist_method)
    return np.asarray(counts).astype(np.int64)


def encode(st: Staged, hist_method: str | None = None,
           pack_method: str | None = None,
           lengths: np.ndarray | None = None) -> EncodeResult:
    """Device-resident encode: histogram -> tables -> code lookup ->
    bit-pack -> dense payload compaction, all on device. Host work is the
    deterministic table build (256 contexts, ~1 ms native) and the unit
    length index — the same metadata the container stores.

    `lengths` overrides the histogram+table-build stage with precomputed
    code lengths (the hybrid executor builds them from a global host+
    device histogram).

    Dispatch order is stage-major across chunks so the per-chunk host
    sync on bit lengths (needed for compaction offsets) overlaps with the
    packing of later chunks."""
    import os
    model = get_model(st.mode)
    encode_fn = api._packer(pack_method or api._default_pack_method())

    lengths_pending = None
    if lengths is None:
        # auto: device build below 8 MB — there the counts-fetch sync is
        # the larger fixed cost; host C++ build above (the builders are
        # asserted bit-identical, so containers don't change)
        build = os.environ.get("MHC_TABLE_BUILD", "auto")
        if build == "auto":
            build = ("device" if st.n_units * st.decode_unit <= (8 << 20)
                     else "host")
        if build == "device":
            # keep the counts ON DEVICE and chain the deterministic
            # builder into the dispatch stream; the uint8 header copy is
            # fetched asynchronously
            from .ops import huffman
            counts_dev = api._histogram(
                model, zip(st.units, st.n_valid),
                hist_method or api._default_hist_method())
            lengths = huffman.code_lengths(
                huffman.rescale_counts_jax(counts_dev))
            lengths_pending = lengths.astype(jnp.uint8)
            lengths_pending.copy_to_host_async()
        else:
            counts = histogram(st, hist_method)
            lengths = model.lengths_from_counts(counts)
    tables = model.tables_from_lengths(lengths)
    lengths_host = (None if lengths_pending is not None
                    else np.asarray(lengths, dtype=np.uint8))

    # The ENGINE payload is ALWAYS word-aligned u32 — the container's
    # unaligned order-0 layout is produced on the host at assembly time
    # (fetch_payload), never by per-byte device compaction.
    raw_units = st.decode_unit != st.block_size    # substream layout
    aligned = container.aligned_payload(model.mode)
    packed = []
    for ud, nvd in zip(st.units, st.n_valid):
        words, bits = encode_fn(ud, nvd, tables["codes"], tables["lengths"])
        if raw_units:
            words, bits = bitpack.substitute_raw_units(words, bits, ud, nvd,
                                                       aligned)
        bits.copy_to_host_async()
        packed.append((words, bits))

    payload = []
    payload_n = []
    bit_parts = []
    for words, bits in packed:
        bits_h = np.asarray(bits).astype(np.int64)
        bit_parts.append(bits_h)
        lens = (bits_h + 31) // 32          # internal WORD lens per unit
        offsets = np.zeros(len(lens) + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        pad = max(-(-total // (1 << 18)) << 18, 1 << 18)
        payload.append(api._compact_words(
            words, jnp.asarray(offsets), pad))
        payload_n.append(total)
    jax.block_until_ready(payload)
    if lengths_host is None:
        lengths_host = np.asarray(lengths_pending, dtype=np.uint8)
    bit_lens = np.concatenate(bit_parts)[: st.n_units]
    return EncodeResult(
        mode=st.mode, block_size=st.block_size, decode_unit=st.decode_unit,
        orig_len=st.orig_len, n_units=st.n_units, chunk=st.chunk,
        lengths=lengths_host,
        byte_lens=container.stream_byte_lens(bit_lens, model.mode),
        bit_lens=bit_lens, payload=payload, payload_n=payload_n)


def _n_valid(enc: EncodeResult, lo: int, hi: int, rows: int) -> np.ndarray:
    """(rows,) int32 symbol counts for units [lo, hi), zero-padded."""
    du = enc.decode_unit
    nv = np.zeros(rows, np.int32)
    nv[: hi - lo] = du
    if hi == enc.n_units:
        nv[hi - lo - 1] = enc.orig_len - (enc.n_units - 1) * du
    return nv


def _decode_repacked(enc: EncodeResult, tables, model, decode, W: int,
                     wl_all: np.ndarray, raw_all: np.ndarray) -> list:
    """Literal-aware device decode: literal units cost the symbol decoder
    the same per-lane work as coded ones, so with literals present the
    units are REPACKED — entropy-coded units gathered into full decode
    batches (ceil(n_coded/C) dispatches instead of ceil(n_units/C)),
    literal units expanded and byte-unpacked only — then a device row
    gather restores original chunk order. All work is on-device and
    inside the decode timing."""
    R = enc.n_units
    du = enc.decode_unit
    C = enc.chunk
    wl = wl_all[:R].astype(np.int64)
    nv_all = _n_valid(enc, 0, R, R)
    # global word offsets into the concatenation of the per-chunk
    # payloads (chunk k's units were compacted chunk-locally)
    offs = np.zeros(R, np.int64)
    base = 0
    for k, n in enumerate(enc.payload_n):
        lo, hi = k * C, min(k * C + C, R)
        local = np.zeros(hi - lo, np.int64)
        np.cumsum(wl[lo:hi - 1] if hi - lo > 1 else wl[lo:lo],
                  out=local[1:])
        offs[lo:hi] = base + local
        base += n
    parts = [p[:n] for p, n in zip(enc.payload, enc.payload_n)]
    parts.append(jnp.zeros((W,), jnp.uint32))      # expand slack
    payload_all = jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    def groups(idx):
        for g in range(0, len(idx), C):
            sel = idx[g:g + C]
            o = np.zeros(C, np.int32)
            ln = np.zeros(C, np.int32)
            nv = np.zeros(C, np.int32)
            o[: len(sel)] = offs[sel]
            ln[: len(sel)] = wl[sel]
            nv[: len(sel)] = nv_all[sel]
            yield api._expand_words_u32(
                payload_all, jnp.asarray(np.concatenate([o, [0]])),
                jnp.asarray(ln), W), nv

    nonraw_idx = np.where(~raw_all)[0]
    raw_idx = np.where(raw_all)[0]
    decoded = [decode(words_d, nv, tables, du, model.markov)
               for words_d, nv in groups(nonraw_idx)]
    n_nr_pad = len(decoded) * C
    for words_d, _ in groups(raw_idx):
        decoded.append(bitpack.words_to_unit_bytes(words_d, du))
    big = decoded[0] if len(decoded) == 1 else jnp.concatenate(
        decoded, axis=0)
    pos = np.empty(R, np.int64)
    pos[nonraw_idx] = np.arange(len(nonraw_idx))
    pos[raw_idx] = n_nr_pad + np.arange(len(raw_idx))
    outs = []
    for lo in range(0, R, C):
        hi = min(lo + C, R)
        p = np.zeros(C, np.int64)
        p[: hi - lo] = pos[lo:hi]
        outs.append(jnp.take(big, jnp.asarray(p), axis=0))
    jax.block_until_ready(outs)
    return outs


def decode(enc: EncodeResult, decode_method: str | None = None,
           interpret: bool = False) -> list:
    """Device-resident decode: tables from the length header -> word
    expansion -> block-parallel symbol decode. Returns the per-chunk
    (C, decode_unit) uint8 device arrays (positions past a unit's true
    length are zero; fetch_bytes trims). `interpret` runs the Pallas
    decoder in interpret mode (CPU tests)."""
    decode_fn = api.decode_fn(decode_method or api._default_decode_method(),
                              interpret=interpret)
    model = get_model(enc.mode)
    tables = model.tables_from_lengths(jnp.asarray(enc.lengths, jnp.int32))
    du = enc.decode_unit
    C = enc.chunk
    W_worst = bitpack.words_for_block(du)
    wl_all = ((enc.bit_lens + 31) // 32) if enc.payload_aligned \
        else -(-enc.byte_lens // 4)
    max_wl = int(wl_all.max()) if enc.n_units else 0
    W = min(W_worst, max(-(-(max_wl + 1) // 128) * 128, 128))

    raw_units = enc.raw_units and enc.decode_unit != enc.block_size
    # Literal detection follows the CONTAINER layout (the substitution
    # rule) — the engine's internal payload is word-aligned for every
    # mode, but order-0 containers are byte-laid-out, so detecting on
    # word counts misclassifies near-incompressible coded units whose
    # word count rounds up to the literal's.
    cont_aligned = container.aligned_payload(model.mode)
    sl_cont_all = container.stream_byte_lens(enc.bit_lens, model.mode)
    if raw_units and enc.payload_aligned and enc.n_units:
        raw_all = bitpack.raw_unit_mask(
            sl_cont_all[: enc.n_units], _n_valid(enc, 0, enc.n_units,
                                                 enc.n_units), cont_aligned)
        n_nonraw = int((~raw_all).sum())
        # Repack ONLY when it saves whole decode dispatches: the reorder
        # gather costs about one pass over the output, so at shapes where
        # ceil(nonraw/C) == n_chunks the plain overwrite path is cheaper
        if raw_all.any() and -(-n_nonraw // C) < len(enc.payload):
            return _decode_repacked(enc, tables, model, decode_fn, W,
                                    wl_all, raw_all)
    outs = []
    for k, payload_d in enumerate(enc.payload):
        lo = k * C
        hi = min(lo + C, enc.n_units)
        nv = _n_valid(enc, lo, hi, C)
        if enc.payload_aligned:
            lens = api._pad_rows(wl_all[lo:hi].astype(np.int32), C)
            offsets = np.zeros(C + 1, np.int32)
            np.cumsum(lens, out=offsets[1:])
            words_d = api._expand_words_u32(
                payload_d, jnp.asarray(offsets), jnp.asarray(lens), W)
        else:
            # hybrid-staged prefix of an UNALIGNED container: per-byte
            # expansion of the container's dense byte payload
            bl = api._pad_rows(enc.byte_lens[lo:hi].astype(np.int32), C)
            offsets = np.zeros(C + 1, np.int32)
            np.cumsum(bl, out=offsets[1:])
            words_d = bitpack.device_expand_words(
                payload_d, jnp.asarray(offsets), jnp.asarray(bl), W)
        out = decode_fn(words_d, nv, tables, du, model.markov)
        if raw_units:
            # literal units: overwrite the garbage entropy-decode rows
            # with the payload bytes — device-side so the decode metric
            # covers the literal path too (detection on the CONTAINER
            # layout, see above)
            sl = api._pad_rows(
                sl_cont_all[lo:hi].astype(np.int64), C)
            raw_m = bitpack.raw_unit_mask(sl, nv, cont_aligned)
            if raw_m.any():
                out = jnp.where(
                    jnp.asarray(raw_m)[:, None],
                    bitpack.words_to_unit_bytes(words_d, du), out)
        outs.append(out)
    jax.block_until_ready(outs)
    return outs


def fetch_bytes(enc: EncodeResult, outs: list) -> bytes:
    """Decoded chunks -> original bytes (host). NOT codec time."""
    parts = [np.asarray(o).reshape(-1) for o in outs]
    return b"".join(p.tobytes() for p in parts)[: enc.orig_len]


def fetch_payload(enc: EncodeResult) -> bytes:
    """Dense CONTAINER-layout payload bytes (host). NOT codec time.

    The engine payload is word-aligned internally; unaligned-container
    modes (order-0) are re-packed on the host here — a memoryview slice
    per unit, the same work the reference does when writing its file."""
    model = get_model(enc.mode)
    aligned_container = container.aligned_payload(model.mode)
    parts = []
    C = enc.chunk
    for k, (payload_d, n) in enumerate(zip(enc.payload, enc.payload_n)):
        h = np.asarray(payload_d)[:n]
        if h.dtype != np.uint32:              # hybrid-staged byte payload
            parts.append(h.tobytes())
            continue
        raw = h.astype(">u4").tobytes()
        if aligned_container or not enc.payload_aligned:
            parts.append(raw)
            continue
        # aligned internal words -> unaligned dense container bytes
        lo = k * C
        hi = min(lo + C, enc.n_units)
        wl = (enc.bit_lens[lo:hi] + 31) // 32
        bl = (enc.bit_lens[lo:hi] + 7) // 8
        mv = memoryview(raw)
        off = 0
        for w, b in zip(wl, bl):
            parts.append(mv[4 * off: 4 * off + int(b)])
            off += int(w)
    return b"".join(parts)


def assemble_container(enc: EncodeResult, data_crc: int | None) -> bytes:
    """Container bytes from an EncodeResult — byte-identical to
    api.compress on the same input/params (tested)."""
    model = get_model(enc.mode)
    return container.build_container(
        model.mode, enc.orig_len, enc.block_size, enc.lengths,
        enc.bit_lens, fetch_payload(enc), data_crc,
        decode_unit=enc.decode_unit)
