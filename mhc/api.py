"""Public single-process API: compress / decompress.

Capability parity: reference L4 encode/decode drivers (SURVEY.md §2 L4,
§3.1–3.3; mount empty, §0) — two-pass encode (stats, then emit) and
single-pass decode — re-expressed as batched device programs:

  compress:   bytes -> (B, n) block batch -> histogram -> code lengths
              (tree-free Huffman) -> canonical tables -> block-parallel
              bit-pack -> container assembly
  decompress: container -> tables from lengths -> block-parallel symbol
              decode (GPU kernel or XLA scan) -> bytes (+ crc verify)

Multi-chip sharded variants live in `parallel/pipeline.py`.
"""

from __future__ import annotations

import os
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import container
from .models.entropy import get_model
from .ops import bitpack

DEFAULT_BLOCK_SIZE = 64 * 1024
# Sequential decode length per lane. Smaller units = more decode lanes
# and fewer sequential steps, but each unit costs index bytes, payload
# alignment padding, and a context reset. 8 KB keeps the 100 MB markov
# container under the reference oracle (0.99991 vs oracle; 4 KB was
# 1.00037 with the aligned layout). Order-0 units are longer: its tables
# are context-free, so a longer unit costs little and minimizes index
# overhead.
DEFAULT_DECODE_UNIT = 8192
DEFAULT_DECODE_UNIT_ORDER0 = 16384


# Implementation choices are resolved in mhc.config (one source of
# truth). The _default_* names are the spelling used by benches/tests.
from . import config as _cfg

_default_hist_method = _cfg.hist_method
_default_decode_method = _cfg.decode_method
_default_pack_method = _cfg.pack_method


def blockify(data: bytes | np.ndarray, block_size: int):
    """bytes -> ((B, block_size) uint8 padded batch, (B,) int32 valid)."""
    flat = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.asarray(data, dtype=np.uint8).reshape(-1)
    n = flat.size
    if n == 0:
        return np.zeros((0, block_size), np.uint8), np.zeros((0,), np.int32)
    B = (n + block_size - 1) // block_size
    padded = np.zeros(B * block_size, dtype=np.uint8)
    padded[:n] = flat
    n_valid = np.full(B, block_size, dtype=np.int32)
    n_valid[-1] = n - (B - 1) * block_size
    return padded.reshape(B, block_size), n_valid


def build_tables(model, blocks: np.ndarray, n_valid: np.ndarray,
                 hist_method: str | None = None):
    """Two-pass stage 1: global histogram + canonical tables. Returns
    (tables dict of device arrays, lengths uint8 host array for the header)."""
    model = get_model(model)
    method = hist_method or _default_hist_method()
    counts = model.histogram(jnp.asarray(blocks), jnp.asarray(n_valid),
                             method=method)
    lengths = model.lengths_from_counts(np.asarray(counts))
    tables = model.tables_from_lengths(lengths)
    return tables, np.asarray(lengths, dtype=np.uint8)


@jax.jit
def lookup_cl_t(units, n_valid, tables):
    """Per-symbol PACKED (len<<16 | code) u32 lookup of (B, n) units in
    STEP-MAJOR (n, B) layout. One body with lookup_cl_sm (delegation), so
    the two forms are bit-identical."""
    return lookup_cl_sm(units.astype(jnp.int32).T, n_valid, tables)


@jax.jit
def lookup_cl_sm(ut, n_valid, tables):
    """lookup_cl_t on PRE-transposed step-major (n, B) units (u8 or i32
    device array). Bit-identical to lookup_cl_t on the unit-major batch
    (tested)."""
    ut = ut.astype(jnp.int32)                    # (n, B)
    n, B = ut.shape
    prev = jnp.concatenate(
        [jnp.zeros((1, B), jnp.int32), ut[:-1]], axis=0)
    cl = bitpack._gather_packed(
        tables["codes"], tables["lengths"], prev, ut)
    valid = jnp.arange(n)[:, None] < n_valid[None, :]
    return jnp.where(valid, cl, jnp.uint32(0))


def resolve_decode_unit(block_size: int, decode_unit: int | None,
                        markov: bool = True) -> int:
    """Clamp the decode unit to the block size; units must divide blocks."""
    du = decode_unit or (DEFAULT_DECODE_UNIT if markov
                         else DEFAULT_DECODE_UNIT_ORDER0)
    du = min(du, block_size)
    if block_size % du != 0 or du & (du - 1):
        raise ValueError(
            f"decode_unit {du} must be a power of two dividing "
            f"block_size {block_size}")
    # u16 unit index requires worst-case unit stream < 64 KB
    from .ops.huffman import MAX_CODE_LEN
    if du != block_size and du * MAX_CODE_LEN // 8 >= (1 << 16):
        raise ValueError(f"decode_unit {du} too large for u16 unit index")
    return du


def _histogram(model, devs, hist_method: str):
    """Sum the model histogram over (units, n_valid) device chunks."""
    counts = None
    for ud, nvd in devs:
        c = model.histogram(ud, nvd, method=hist_method)
        counts = c if counts is None else counts + c
    return counts


def _tracer():
    if os.environ.get("MHC_TRACE"):
        from .utils.metrics import Trace
        return Trace()
    return None


def _chunk_units(du: int) -> int:
    """Units per device batch. Chunking bounds HBM/compile size at any
    input size and lets h2d / compute / d2h overlap (async dispatch)."""
    return max(1, (_cfg.chunk_mb() << 20) // du)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _expand_words_u32(payload_d, offsets, word_lens, W):
    """Aligned-payload expansion, implementation from config.expand_impl
    (all three are bit-identical, tested)."""
    impl = _cfg.expand_impl()
    fn = {"slices": bitpack.device_expand_words_slices,
          "blocks": bitpack.device_expand_words_blocks}.get(
        impl, bitpack.device_expand_words_u32)
    return fn(payload_d, offsets, word_lens, W)


def _compact_words(words, offsets, total_pad):
    """Aligned-payload compaction, implementation from
    config.compact_impl (all three are bit-identical, tested)."""
    impl = _cfg.compact_impl()
    fn = {"slices": bitpack.device_compact_words_slices,
          "blocks": bitpack.device_compact_words_blocks}.get(
        impl, bitpack.device_compact_words)
    return fn(words, offsets, total_pad)


def _packer(pack_method: str):
    """The XLA bit packer for `pack_method` (merge | scatter)."""
    try:
        return {"merge": bitpack.encode_blocks_merge,
                "scatter": bitpack.encode_blocks}[pack_method]
    except KeyError:
        raise ValueError(f"unknown pack method {pack_method!r}") from None


def decode_fn(decode_method: str, interpret: bool = False):
    """The symbol decoder for `decode_method` (pallas | scan): a function
    (words, n_valid, tables, n_out, markov) -> (B, n_out) uint8. Both
    produce identical bytes (tested). `interpret` runs the Pallas kernel
    in interpret mode (CPU tests only)."""
    if decode_method == "pallas":
        from .ops.decode_kernel import decode_blocks_kernel
        dec = (partial(decode_blocks_kernel, interpret=True) if interpret
               else decode_blocks_kernel)
    elif decode_method == "scan":
        dec = bitpack.decode_blocks
    else:
        raise ValueError(f"unknown decode method {decode_method!r}")

    def run(words, n_valid, tables, n_out, markov):
        return dec(words, jnp.asarray(n_valid), tables["lim"],
                   tables["base"], tables["first_code"],
                   tables["sorted_syms"], n_out=n_out, markov=markov)
    return run


def compress(data: bytes, mode: str = "markov",
             block_size: int = DEFAULT_BLOCK_SIZE,
             hist_method: str | None = None, crc: bool = True,
             pack_method: str | None = None,
             decode_unit: int | None = None) -> bytes:
    model = get_model(mode)
    if block_size & (block_size - 1):
        raise ValueError("block_size must be a power of two")
    tr = _tracer()
    from contextlib import nullcontext
    ph = (lambda *a, **k: nullcontext()) if tr is None else tr.phase
    du = resolve_decode_unit(block_size, decode_unit, model.markov)
    with ph("blockify", len(data)):
        units, n_valid = blockify(data, du)
    orig_len = len(data)
    with ph("crc32", orig_len):
        checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    R = units.shape[0]
    if R == 0:
        return container.build_container(
            model.mode, 0, block_size,
            np.zeros((256, 256) if model.markov else (256,), np.uint8),
            np.zeros((0,), np.int64), b"", checksum, decode_unit=du)

    # Chunked two-pass pipeline. One chunk == one static compile shape;
    # the last chunk is zero-row-padded (n_valid 0 rows emit no bits, so
    # containers are byte-identical to the monolithic path).
    C = min(_chunk_units(du), R)
    n_chunks = (R + C - 1) // C
    hist_method = hist_method or _default_hist_method()
    pack_method = pack_method or _default_pack_method()
    device_compact = os.environ.get("MHC_DEVICE_COMPACT", "1") != "0"

    with ph("h2d", units.nbytes):
        devs = []
        for k in range(n_chunks):
            lo = k * C
            u = _pad_rows(units[lo:lo + C], C)
            nv = _pad_rows(n_valid[lo:lo + C], C)
            devs.append((jnp.asarray(u), jnp.asarray(nv)))
    with ph("tables", orig_len):
        counts = _histogram(model, devs, hist_method)
        counts.copy_to_host_async()   # avoid the slow cold-fetch path
        lengths = model.lengths_from_counts(np.asarray(counts))
        tables = model.tables_from_lengths(lengths)
        lengths_host = np.asarray(lengths, dtype=np.uint8)
    raw_units = du != block_size          # substream layout only
    with ph("pack", orig_len):
        packed = []
        encode = _packer(pack_method)
        for ud, nvd in devs:
            words, bits = encode(ud, nvd, tables["codes"], tables["lengths"])
            if raw_units:
                words, bits = bitpack.substitute_raw_units(
                    words, bits, ud, nvd,
                    container.aligned_payload(model.mode))
            bits.copy_to_host_async()
            packed.append((words, bits))
    bits_parts = []
    enc_fetch = os.environ.get(
        "MHC_ENC_FETCH", "slice" if device_compact else "padded")
    if enc_fetch == "slice":
        # Dense device slice to the chunk-max stream width + host-side
        # native join: no gathers on device, modest extra bytes on the
        # link, ~20x faster than the on-device byte compaction.
        from .utils import native
        with ph("compact", orig_len):
            pending = []
            for words, bits in packed:
                bits_h = np.asarray(bits).astype(np.int64)
                bits_parts.append(bits_h)
                byte_lens = container.stream_byte_lens(bits_h, model.mode)
                wmax = max((int(byte_lens.max()) + 3) // 4, 1) \
                    if byte_lens.size else 1
                wmax32 = min(-(-wmax // 32) * 32, words.shape[1])
                rows_d = bitpack.device_rows_to_bytes(words, wmax32)
                rows_d.copy_to_host_async()
                pending.append((rows_d, byte_lens))
        with ph("d2h", sum(int(b.sum()) for _, b in pending)):
            fetched = []
            for rows_d, byte_lens in pending:
                fetched.append(native.join_rows(np.asarray(rows_d),
                                                byte_lens))
        payload = b"".join(fetched)
    elif enc_fetch == "compact":
        aligned = container.aligned_payload(model.mode)
        with ph("compact", orig_len):
            pending = []
            for words, bits in packed:
                bits_h = np.asarray(bits).astype(np.int64)
                bits_parts.append(bits_h)
                lens = container.stream_byte_lens(bits_h, model.mode)
                if aligned:
                    lens = lens // 4
                offsets = np.zeros(len(lens) + 1, np.int32)
                np.cumsum(lens, out=offsets[1:])
                total = int(offsets[-1])
                gran = (1 << 18) if aligned else (1 << 20)
                pad = max(-(-total // gran) * gran, gran)
                if aligned:
                    payload_d = _compact_words(
                        words, jnp.asarray(offsets), pad)
                else:
                    payload_d = bitpack.device_compact_payload(
                        words, jnp.asarray(offsets), pad)
                payload_d.copy_to_host_async()
                pending.append((payload_d, total))
        with ph("d2h", sum((4 if aligned else 1) * t for _, t in pending)):
            fetched = []
            for payload_d, total in pending:
                flat = np.asarray(payload_d)
                if aligned:
                    fetched.append(flat[:total].astype(">u4").tobytes())
                else:
                    fetched.append(flat[:total].tobytes())
        payload = b"".join(fetched)
    else:
        with ph("d2h", sum(int(w.size) * 4 for w, _ in packed)):
            parts = []
            for words, bits in packed:
                parts.append((np.asarray(words),
                              np.asarray(bits).astype(np.int64)))
        with ph("marshal", orig_len):
            chunks = []
            for words_h, bits_h in parts:
                bits_parts.append(bits_h)
                chunks.append(bitpack.words_to_payload(
                    words_h, bits_h,
                    aligned=container.aligned_payload(model.mode)))
            payload = b"".join(chunks)
    bits_all = np.concatenate(bits_parts)[:R]
    with ph("container", len(payload)):
        blob = container.build_container(
            model.mode, orig_len, block_size, lengths_host, bits_all,
            payload, checksum, decode_unit=du)
    if tr is not None:
        import sys
        print(f"[mhc-trace compress] {tr.dumps()}", file=sys.stderr)
    return blob


def decompress(blob: bytes, verify: bool = True,
               decode_method: str | None = None) -> bytes:
    """decode_method: 'pallas' (the GPU symbol-decode kernel,
    ops/decode_kernel.py) or 'scan' (XLA scan, any backend). Default
    from config.decode_method (the platform rule)."""
    decode = decode_fn(decode_method or _default_decode_method())
    tr = _tracer()
    from contextlib import nullcontext
    ph = (lambda *a, **k: nullcontext()) if tr is None else tr.phase
    meta = container.parse_container(blob)
    model = get_model(meta.mode)
    if meta.orig_len == 0:
        return b""
    with ph("tables", 0):
        tables = model.tables_from_lengths(
            jnp.asarray(meta.lengths, jnp.int32))
        jax.block_until_ready(tables["lim"])
    du = meta.decode_unit or meta.block_size
    device_compact = os.environ.get("MHC_DEVICE_COMPACT", "1") != "0"
    byte_lens_all = meta.byte_lengths.astype(np.int64)
    R = len(byte_lens_all)
    # Stream buffer width: the worst case (15 bits/symbol) pads every unit
    # to ~1.9x the decode unit — size it by the container's actual max
    # stream length (rounded to 128 words so one compile covers all
    # chunks) and keep the worst case only as a cap.
    W_worst = bitpack.words_for_block(du)
    max_bl = int(byte_lens_all.max()) if R else 0
    W = min(W_worst, max(-(-(-(-max_bl // 4) + 1) // 128) * 128, 128))
    C = min(_chunk_units(du), R)
    n_chunks = (R + C - 1) // C
    starts = np.zeros(R + 1, np.int64)
    np.cumsum(byte_lens_all, out=starts[1:])

    outs = []
    for k in range(n_chunks):
        lo = k * C
        hi = min(lo + C, R)
        bl = _pad_rows(byte_lens_all[lo:hi].astype(np.int32), C)
        nv = np.full(C, du, dtype=np.int32)
        nv[hi - lo:] = 0
        if hi == R:
            nv[hi - lo - 1] = meta.orig_len - (R - 1) * du
        if device_compact and not (meta.flags & container.FLAG_ALIGNED_PAYLOAD):
            # legacy (round-1) unaligned container: per-byte expansion
            offsets = np.zeros(C + 1, np.int32)
            np.cumsum(bl, out=offsets[1:])
            total = int(offsets[-1])
            total_pad = max(-(-total // (1 << 20)) << 20, 1 << 20)
            flat = np.zeros(total_pad, np.uint8)
            flat[:total] = np.frombuffer(
                blob, np.uint8, total, meta.payload_off + int(starts[lo]))
            with ph("h2d", total):
                payload_d = jnp.asarray(flat)
            with ph("expand", total):
                words_d = bitpack.device_expand_words(
                    payload_d, jnp.asarray(offsets), jnp.asarray(bl), W)
        elif device_compact:
            word_lens = bl // 4
            offsets = np.zeros(C + 1, np.int32)
            np.cumsum(word_lens, out=offsets[1:])
            total_w = int(offsets[-1])
            pad_w = max(-(-total_w // (1 << 18)) << 18, 1 << 18)
            flat = np.zeros(pad_w, np.uint32)
            raw = np.frombuffer(blob, np.uint8, total_w * 4,
                                meta.payload_off + int(starts[lo]))
            flat[:total_w] = raw.copy().view(">u4")
            with ph("h2d", total_w * 4):
                payload_d = jnp.asarray(flat)
            with ph("expand", total_w * 4):
                words_d = _expand_words_u32(
                    payload_d, jnp.asarray(offsets),
                    jnp.asarray(word_lens), W)
        else:
            with ph("unmarshal", int(bl.sum())):
                words = container.payload_to_words(blob, meta, W,
                                                   lo=lo, hi=hi)
                words = _pad_rows(words, C)
            with ph("h2d", int(words.nbytes)):
                words_d = jnp.asarray(words)
        with ph("decode", (hi - lo) * du):
            out = decode(words_d, nv, tables, du, model.markov)
            if meta.flags & container.FLAG_RAW_UNITS:
                # literal units: overwrite the (garbage) entropy-decode
                # rows with the payload bytes (round 5, FLAG_RAW_UNITS)
                raw_m = bitpack.raw_unit_mask(
                    _pad_rows(byte_lens_all[lo:hi], C), nv,
                    bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD))
                if raw_m.any():
                    out = jnp.where(
                        jnp.asarray(raw_m)[:, None],
                        bitpack.words_to_unit_bytes(words_d, du), out)
            out.copy_to_host_async()
            outs.append(out)
    with ph("d2h", meta.orig_len):
        data = b"".join(np.asarray(o).tobytes()
                        for o in outs)[: meta.orig_len]
    with ph("crc32", meta.orig_len):
        if verify:
            container.verify_crc(data, meta)
    if tr is not None:
        import sys
        print(f"[mhc-trace decompress] {tr.dumps()}", file=sys.stderr)
    return data


# Segment chaining: a file larger than segment_size is stored as a plain
# concatenation of independent containers. Bounds host/device memory and
# keeps every per-context histogram total within int32 (the table-build
# contract — ops/huffman.py), so multi-GB corpora need no special casing.
DEFAULT_SEGMENT_SIZE = 1 << 30


def compress_file(in_path: str, out_path: str, mode: str = "markov",
                  block_size: int = DEFAULT_BLOCK_SIZE,
                  decode_unit: int | None = None, crc: bool = True,
                  segment_size: int = DEFAULT_SEGMENT_SIZE,
                  sharded: bool = False, mesh=None,
                  host_fraction: float | None = None) -> dict:
    """Streaming file compression with segment chaining. Returns stats.
    host_fraction routes that share of units to the hybrid host/device
    executor (hybrid.py); containers are byte-identical either way."""
    total_in = os.path.getsize(in_path)
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, open(out_path, "wb") as out:
        while True:
            seg = f.read(segment_size)
            if not seg and n_segments > 0:
                break
            if sharded:
                from .parallel import pipeline
                blob = pipeline.compress_sharded(
                    seg, mesh, mode=mode, block_size=block_size,
                    crc=crc, decode_unit=decode_unit)
            elif host_fraction is not None:
                from . import hybrid
                blob = hybrid.compress(
                    seg, mode=mode, block_size=block_size, crc=crc,
                    decode_unit=decode_unit, host_fraction=host_fraction)
            else:
                blob = compress(seg, mode=mode, block_size=block_size,
                                crc=crc, decode_unit=decode_unit)
            out.write(blob)
            total_out += len(blob)
            n_segments += 1
            if len(seg) < segment_size:
                break
    return {"orig_bytes": total_in, "compressed_bytes": total_out,
            "ratio": total_out / max(total_in, 1),
            "n_segments": n_segments}


def _next_segment(f, buf: bytes) -> tuple[bytes | None, bytes]:
    """Read exactly one container from file f (with `buf` carry-over from
    the previous read). Returns (segment bytes or None at EOF, new carry).
    Memory is bounded by one segment — never the whole file."""
    if not buf:
        buf = f.read(1 << 18)
        if not buf:
            return None, b""
    while True:
        try:
            meta = container.parse_container(buf, head_only=True)
            break
        except ValueError as e:
            if "truncated" not in str(e):
                raise
            more = f.read(max(len(buf), 1 << 18))
            if not more:
                raise
            buf += more
    size = container.container_size(meta)
    if len(buf) < size:
        rest = f.read(size - len(buf))
        if len(rest) != size - len(buf):
            raise ValueError("mhc: truncated container (payload)")
        return buf + rest, b""
    return buf[:size], buf[size:]


def decompress_file(in_path: str, out_path: str, verify: bool = True,
                    decode_method: str | None = None,
                    sharded: bool = False, mesh=None,
                    host_fraction: float | None = None) -> dict:
    """Streaming decompression of a (possibly segment-chained) file.
    Segments are read and decoded one at a time (constant memory in the
    number of segments — round 1 buffered the entire file)."""
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, open(out_path, "wb") as out:
        carry = b""
        while True:
            seg, carry = _next_segment(f, carry)
            if seg is None:
                break
            if sharded:
                from .parallel import pipeline
                data = pipeline.decompress_sharded(seg, mesh, verify=verify)
            elif host_fraction is not None:
                from . import hybrid
                data = hybrid.decompress(seg, verify=verify,
                                         host_fraction=host_fraction,
                                         decode_method=decode_method)
            else:
                data = decompress(seg, verify=verify,
                                  decode_method=decode_method)
            out.write(data)
            total_out += len(data)
            n_segments += 1
    return {"orig_bytes": total_out, "n_segments": n_segments}


def compression_report(data: bytes, blob: bytes) -> dict:
    """Structured size accounting (SURVEY.md §5 metrics/observability)."""
    meta = container.parse_container(blob)
    index_bytes = meta.index_bytes
    table_bytes = meta.payload_off - 24 - index_bytes
    payload = int(meta.byte_lengths.sum())
    return {
        "orig_bytes": len(data),
        "compressed_bytes": len(blob),
        "ratio": len(blob) / max(len(data), 1),
        "payload_bytes": payload,
        "table_bytes": table_bytes,
        "index_bytes": index_bytes,
        "header_bytes": 24,
        "n_blocks": meta.n_blocks,
        "n_units": len(meta.byte_lengths),
        "block_size": meta.block_size,
        "decode_unit": meta.decode_unit or meta.block_size,
        "mode": "markov" if meta.mode == container.MODE_MARKOV else "huffman",
    }
