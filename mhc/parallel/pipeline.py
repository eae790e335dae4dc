"""Sharded two-pass codec pipeline (BASELINE.json:10-11).

Mapping of the mandated capabilities onto JAX collectives:

  two-pass global histogram   -> per-shard histogram, `psum` over the
                                 data axis (NVLink within a host, the
                                 network across hosts)
  broadcast of shared tables  -> tables are built REPLICATED: every device
                                 runs the deterministic table construction
                                 on the identical psum'd counts, a
                                 collective-free broadcast (no host
                                 roundtrip, bit-identical by the
                                 determinism contract in huffman.py)
  block-parallel encode/decode-> each shard packs/unpacks its own blocks
  ordered gather              -> the shard_map output is a global Array
                                 whose logical order IS the block order;
                                 materializing it on host is the gather

The reference is a single-threaded CLI with none of this (SURVEY.md §2b).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bitpack, canonical, histogram, huffman
from .mesh import DATA_AXIS, make_mesh, pad_to_multiple


def _build_tables_shard(counts, markov: bool):
    """Replicated table construction from (already psum'd) counts."""
    scaled = huffman.rescale_counts_jax(counts)
    lengths = huffman.code_lengths(scaled)
    t = canonical.canonical_codes(lengths)
    if not markov:
        t = {k: jnp.broadcast_to(v, (256,) + v.shape) for k, v in t.items()}
    return t, lengths


@partial(jax.jit, static_argnames=("markov", "axis", "mesh", "hist_method"))
def _encode_sharded(blocks, n_valid, *, markov: bool, mesh: Mesh,
                    axis: str = DATA_AXIS, hist_method: str = "matmul"):
    """Full fused encode step over the mesh. blocks (B, n) sharded on B."""

    def shard_fn(blocks, n_valid):
        if markov:
            local = histogram.histogram_markov(blocks, n_valid,
                                               method=hist_method)
        else:
            local = histogram.histogram_order0(blocks, n_valid,
                                               method=hist_method)
        counts = jax.lax.psum(local, axis)
        t, lengths = _build_tables_shard(counts, markov)
        words, bits = bitpack.encode_blocks_merge(blocks, n_valid,
                                                  t["codes"], t["lengths"])
        return words, bits, lengths

    # check_vma=False: the VMA tracker cannot see that psum + deterministic
    # table build leaves `lengths` replicated (scan carries trip it); the
    # determinism contract in ops/huffman.py is what guarantees it.
    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )(blocks, n_valid)


@partial(jax.jit, static_argnames=("markov", "n_out", "axis", "mesh",
                                   "method", "interpret"))
def _decode_sharded(words, n_valid, lengths, *, markov: bool, n_out: int,
                    mesh: Mesh, axis: str = DATA_AXIS,
                    method: str = "scan", interpret: bool = False):
    """Sharded decode: words (B, W) sharded on B, lengths replicated.

    Each shard runs the same symbol decoder the single-device path
    compiles (method='pallas': the GPU kernel; 'scan': the XLA scan).
    `interpret` exercises the kernel path on the CPU mesh."""
    from ..api import decode_fn
    decode = decode_fn(method, interpret=interpret)

    def shard_fn(words, n_valid, lengths):
        t, _ = _build_tables_shard_from_lengths(lengths, markov)
        return decode(words, n_valid, t, n_out, markov)

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )(words, n_valid, lengths)


def _build_tables_shard_from_lengths(lengths, markov: bool):
    t = canonical.canonical_codes(lengths.astype(jnp.int32))
    if not markov:
        t = {k: jnp.broadcast_to(v, (256,) + v.shape) for k, v in t.items()}
    return t, lengths


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans processes (multi-host pod)."""
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def _to_global(host_array: np.ndarray, sharding):
    """Place a host array (full copy on every process) onto a sharding
    that may span processes."""
    if is_multiprocess(sharding.mesh):
        # every host holds the full array; JAX slices out local shards
        return jax.make_array_from_process_local_data(
            sharding, host_array, global_shape=host_array.shape)
    return jax.device_put(host_array, sharding)


def _to_host(global_array) -> np.ndarray:
    """Ordered gather of a (possibly cross-process) sharded array."""
    arr = jax.block_until_ready(global_array)
    if arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def shard_blocks(blocks: np.ndarray, n_valid: np.ndarray, mesh: Mesh,
                 axis: str = DATA_AXIS):
    """Pad the block batch to the shard count and place it on the mesh.

    Multi-host contract: every process passes the identical full block
    batch (each host reads the same input), and JAX materializes only
    the local shards."""
    n_shards = mesh.shape[axis]
    B = blocks.shape[0]
    Bp = pad_to_multiple(max(B, 1), n_shards)
    if Bp != B:
        blocks = np.concatenate(
            [blocks, np.zeros((Bp - B,) + blocks.shape[1:], blocks.dtype)])
        n_valid = np.concatenate(
            [n_valid, np.zeros((Bp - B,), n_valid.dtype)])
    sharding = NamedSharding(mesh, P(axis))
    return (_to_global(blocks, sharding),
            _to_global(n_valid, NamedSharding(mesh, P(axis))), B)


@partial(jax.jit, static_argnames=("markov", "axis", "mesh", "hist_method"))
def _hist_sharded(blocks, n_valid, *, markov: bool, mesh: Mesh,
                  axis: str = DATA_AXIS, hist_method: str = "matmul"):
    """Per-shard histogram + psum -> replicated (256[,256]) counts."""

    def shard_fn(b, nv):
        if markov:
            local = histogram.histogram_markov(b, nv, method=hist_method)
        else:
            local = histogram.histogram_order0(b, nv, method=hist_method)
        return jax.lax.psum(local, axis)

    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(),
        check_vma=False)(blocks, n_valid)


@jax.jit
def _lengths_from_counts_dev(counts):
    """Replicated deterministic table build (device twin of the host
    builder — bit-identical, tested in test_huffman)."""
    return huffman.code_lengths(huffman.rescale_counts_jax(counts))


@partial(jax.jit, static_argnames=("markov", "axis", "mesh"))
def _pack_sharded(blocks, n_valid, lengths, *, markov: bool, mesh: Mesh,
                  axis: str = DATA_AXIS):
    """Sharded emit pass with precomputed (replicated) code lengths."""

    def shard_fn(b, nv, lengths):
        t, _ = _build_tables_shard_from_lengths(lengths, markov)
        return bitpack.encode_blocks_merge(b, nv, t["codes"], t["lengths"])

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False)(blocks, n_valid, lengths)


def encode_sharded(blocks: np.ndarray, n_valid: np.ndarray, mesh: Mesh,
                   markov: bool = True, hist_method: str = "matmul"):
    """Two-pass sharded encode. Returns host (words, bits, lengths) trimmed
    back to the original block count (the ordered gather)."""
    blocks_d, nv_d, B = shard_blocks(blocks, n_valid, mesh)
    words, bits, lengths = _encode_sharded(
        blocks_d, nv_d, markov=markov, mesh=mesh, hist_method=hist_method)
    return (_to_host(words)[:B], _to_host(bits)[:B],
            np.asarray(lengths, dtype=np.uint8))


def decode_sharded_device(words: np.ndarray, n_valid: np.ndarray,
                          lengths: np.ndarray, mesh: Mesh, n_out: int,
                          markov: bool = True,
                          decode_method: str | None = None,
                          interpret: bool = False):
    """Sharded decode of a block batch; returns (global (Bp, n_out)
    uint8 device Array, B) — the caller picks the gather strategy."""
    n_shards = mesh.shape[DATA_AXIS]
    B = words.shape[0]
    Bp = pad_to_multiple(max(B, 1), n_shards)
    if Bp != B:
        words = np.concatenate(
            [words, np.zeros((Bp - B, words.shape[1]), words.dtype)])
        n_valid = np.concatenate([n_valid, np.zeros((Bp - B,), n_valid.dtype)])
    from .. import config
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    out = _decode_sharded(
        _to_global(words, sharding),
        _to_global(n_valid, sharding),
        _to_global(np.asarray(lengths, np.int32),
                   NamedSharding(mesh, P())),
        markov=markov, n_out=n_out, mesh=mesh,
        method=decode_method or config.decode_method(), interpret=interpret)
    return out, B


def decode_sharded(words: np.ndarray, n_valid: np.ndarray,
                   lengths: np.ndarray, mesh: Mesh, n_out: int,
                   markov: bool = True, decode_method: str | None = None,
                   interpret: bool = False) -> np.ndarray:
    """Sharded decode of a block batch; returns (B, n_out) uint8 on host."""
    out, B = decode_sharded_device(words, n_valid, lengths, mesh, n_out,
                                   markov=markov,
                                   decode_method=decode_method,
                                   interpret=interpret)
    return _to_host(out)[:B]


# ---------------------------------------------------------------------------
# container-level sharded API (mirrors api.compress/decompress)
# ---------------------------------------------------------------------------

def _chunk_units_sharded(du: int, mesh: Mesh) -> int:
    """Units per sharded dispatch: same memory target as the
    single-device chunking, rounded up to the shard count."""
    from ..api import _chunk_units
    n_shards = mesh.shape[DATA_AXIS]
    return pad_to_multiple(max(_chunk_units(du), n_shards), n_shards)


def compress_sharded(data: bytes, mesh: Mesh | None = None,
                     mode: str = "markov", block_size: int = 64 * 1024,
                     crc: bool = True, decode_unit: int | None = None) -> bytes:
    """Chunked two-pass sharded compress — bounded host/device memory at
    any input size (BASELINE.json:10 config-4 scale), byte-identical to
    api.compress (tested at 100 MB in test_scale.py).

    Pass 1 psums per-chunk histograms into one replicated count array;
    the tables are then built ONCE (replicated deterministic device
    build) and pass 2 packs chunk by chunk, fetching only the chunk-max
    stream width across the link."""
    import zlib

    from .. import container
    from ..api import blockify, resolve_decode_unit
    from ..models.entropy import get_model

    model = get_model(mode)
    mesh = mesh or make_mesh()
    du = resolve_decode_unit(block_size, decode_unit, model.markov)
    units, n_valid = blockify(data, du)
    checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    R = units.shape[0]
    if R == 0:
        return container.build_container(
            model.mode, 0, block_size,
            np.zeros((256, 256) if model.markov else (256,), np.uint8),
            np.zeros((0,), np.int64), b"", checksum, decode_unit=du)

    C = min(_chunk_units_sharded(du, mesh), pad_to_multiple(
        R, mesh.shape[DATA_AXIS]))
    chunks = []
    for lo in range(0, R, C):
        hi = min(lo + C, R)
        chunks.append(shard_blocks(units[lo:hi], n_valid[lo:hi], mesh))

    from ..api import _default_hist_method
    counts = None
    for blocks_d, nv_d, _ in chunks:
        c = _hist_sharded(blocks_d, nv_d, markov=model.markov, mesh=mesh,
                          hist_method=_default_hist_method())
        counts = c if counts is None else counts + c
    lengths_dev = _lengths_from_counts_dev(counts)
    lengths_host = np.asarray(lengths_dev, dtype=np.uint8)

    bits_parts, payload_parts = [], []
    raw_units = du != block_size
    for blocks_d, nv_d, B in chunks:
        words, bits = _pack_sharded(blocks_d, nv_d, lengths_dev,
                                    markov=model.markov, mesh=mesh)
        if raw_units:
            # literal substitution (round 5) on the sharded arrays —
            # elementwise over the block axis, so it stays sharded and
            # the container remains byte-identical to api.compress
            words, bits = bitpack.substitute_raw_units(
                words, bits, blocks_d, nv_d,
                container.aligned_payload(model.mode))
        bits_h = _to_host(bits)[:B].astype(np.int64)
        bits_parts.append(bits_h)
        # fetch only the chunk-max (layout-aware) stream width
        byte_lens = container.stream_byte_lens(bits_h, model.mode)
        wmax = max(-(-int(byte_lens.max()) // 4), 1) if byte_lens.size else 1
        wmax32 = min(-(-wmax // 32) * 32, words.shape[1])
        words_h = _to_host(words[:, :wmax32])[:B]
        raw = np.ascontiguousarray(words_h.astype(">u4")).view(np.uint8)
        raw = raw.reshape(B, -1)
        from ..utils import native
        payload_parts.append(native.join_rows(raw, byte_lens))
    bits_all = np.concatenate(bits_parts)
    payload = b"".join(payload_parts)
    return container.build_container(model.mode, len(data), block_size,
                                     lengths_host, bits_all, payload,
                                     checksum, decode_unit=du)


def decompress_sharded(blob: bytes, mesh: Mesh | None = None,
                       verify: bool = True,
                       decode_method: str | None = None,
                       interpret: bool = False) -> bytes:
    """Chunked sharded decode. The per-shard decoder follows the
    platform rule (config.decode_method): the Pallas kernel on GPU —
    each device runs the program the single-device path compiles — and
    the XLA scan on CPU meshes. `interpret` runs the kernel in Pallas
    interpret mode (CPU-mesh differential tests)."""
    from .. import container
    from ..models.entropy import get_model

    meta = container.parse_container(blob)
    model = get_model(meta.mode)
    if meta.orig_len == 0:
        return b""
    mesh = mesh or make_mesh()
    du = meta.decode_unit or meta.block_size
    byte_lens = meta.byte_lengths.astype(np.int64)
    R = len(byte_lens)
    W_worst = bitpack.words_for_block(du)
    max_wl = int(byte_lens.max()) // 4 if R else 0
    W = min(W_worst, max(max_wl + 1, 4))
    C = min(_chunk_units_sharded(du, mesh), pad_to_multiple(
        R, mesh.shape[DATA_AXIS]))
    parts = []
    for lo in range(0, R, C):
        hi = min(lo + C, R)
        words = container.payload_to_words(blob, meta, W, lo=lo, hi=hi)
        nv = np.full(hi - lo, du, dtype=np.int32)
        if hi == R:
            nv[-1] = meta.orig_len - (R - 1) * du
        out = decode_sharded(words, nv, meta.lengths, mesh,
                             n_out=du, markov=model.markov,
                             decode_method=decode_method,
                             interpret=interpret)
        if meta.flags & container.FLAG_RAW_UNITS:
            # literal units: replace the garbage entropy-decode rows
            # with the payload bytes (host-side — the gathered output
            # is already on host here)
            raw_m = bitpack.raw_unit_mask(
                byte_lens[lo:hi], nv,
                bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD))
            if raw_m.any():
                out = np.array(out, copy=True)
                # host-side unpack: words is already host np here
                w = np.zeros((int(raw_m.sum()), du // 4), np.uint32)
                src = words[: hi - lo][raw_m][:, : du // 4]
                w[:, : src.shape[1]] = src
                lits = w.astype(">u4").view(np.uint8).reshape(-1, du)
                out[raw_m] = lits
        parts.append(out.reshape(-1)[: (hi - lo - 1) * du + nv[-1]])
    data = b"".join(p.tobytes() for p in parts)
    if verify:
        container.verify_crc(data, meta)
    return data
