"""Command-line interface.

Capability parity: reference L5 `main()` — encode/decode × order-0/markov
over file paths (SURVEY.md §2 L5; mount empty, §0).

    mhc encode --mode markov  --block-size 64K  IN OUT
    mhc decode IN OUT
    mhc stat   IN            (inspect a container)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("K", 1024), ("M", 1024 ** 2), ("G", 1024 ** 3)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mhc", description="Markov-Huffman codec")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="compress a file")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--mode", default="markov",
                    choices=["markov", "huffman", "order0"])
    pe.add_argument("--block-size", default="64K", type=_parse_size)
    pe.add_argument("--decode-unit", default=None, type=_parse_size,
                    help="independent decode granularity (default 8K markov, 16K order-0; "
                    "power of two dividing block-size)")
    pe.add_argument("--no-crc", action="store_true")
    pe.add_argument("--segment-size", default="1G", type=_parse_size,
                    help="stream files in independent segments (bounds "
                    "memory; multi-GB inputs become chained containers)")
    pe.add_argument("--sharded", action="store_true",
                    help="data-parallel over all local devices")
    pe.add_argument("--distributed", action="store_true",
                    help="jax.distributed.initialize() first (multi-host)")
    pe.add_argument("--host-fraction", default=None, type=float,
                    help="hybrid executor: share of units encoded by "
                    "host C++ threads (0..1; containers are identical)")
    pe.add_argument("--report", action="store_true",
                    help="print a JSON size/throughput report")

    pd = sub.add_parser("decode", help="decompress a file")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--no-verify", action="store_true")
    pd.add_argument("--decode-method", default=None,
                    choices=["scan", "pallas"],
                    help="default: pallas (GPU kernel) on GPU, scan on CPU")
    pd.add_argument("--host-fraction", default=None, type=float,
                    help="hybrid executor: share of units decoded by "
                    "host C++ threads (0..1)")
    pd.add_argument("--sharded", action="store_true")
    pd.add_argument("--distributed", action="store_true")
    pd.add_argument("--report", action="store_true")

    ps = sub.add_parser("stat", help="inspect a container header")
    ps.add_argument("input")

    args = p.parse_args(argv)

    from . import api, container  # deferred: JAX init is slow

    try:
        return _run(args, api, container)
    except (ValueError, OSError) as e:
        print(f"mhc: error: {e}", file=sys.stderr)
        return 1


def _run(args, api, container) -> int:
    if getattr(args, "distributed", False):
        import jax
        jax.distributed.initialize()

    if args.cmd == "encode":
        t0 = time.perf_counter()
        rep = api.compress_file(
            args.input, args.output, mode=args.mode,
            block_size=args.block_size, decode_unit=args.decode_unit,
            crc=not args.no_crc, segment_size=args.segment_size,
            sharded=args.sharded, host_fraction=args.host_fraction)
        dt = time.perf_counter() - t0
        if args.report:
            rep["encode_seconds"] = dt
            rep["encode_MBps"] = (rep["orig_bytes"] / dt / 1e6
                                  if dt else None)
            print(json.dumps(rep))
        else:
            print(f"{args.input}: {rep['orig_bytes']} -> "
                  f"{rep['compressed_bytes']} bytes "
                  f"({rep['ratio']:.4f}) in {dt:.3f}s")
        return 0

    if args.cmd == "decode":
        t0 = time.perf_counter()
        rep = api.decompress_file(
            args.input, args.output, verify=not args.no_verify,
            decode_method=args.decode_method, sharded=args.sharded,
            host_fraction=args.host_fraction)
        dt = time.perf_counter() - t0
        if args.report:
            rep["decode_seconds"] = dt
            rep["decode_MBps"] = (rep["orig_bytes"] / dt / 1e6
                                  if dt else None)
            print(json.dumps(rep))
        else:
            print(f"{args.input}: -> {rep['orig_bytes']} bytes "
                  f"in {dt:.3f}s")
        return 0

    if args.cmd == "stat":
        blob = open(args.input, "rb").read()
        meta = container.parse_container(blob)
        # byte_lengths covers both layouts (the default sub-stream layout
        # leaves bit_lengths empty — round-1 stat reported 0 payload)
        payload = int(meta.byte_lengths.sum())
        print(json.dumps({
            "mode": "markov" if meta.mode == container.MODE_MARKOV else "huffman",
            "orig_len": meta.orig_len,
            "block_size": meta.block_size,
            "decode_unit": meta.decode_unit or meta.block_size,
            "n_blocks": meta.n_blocks,
            "n_units": len(meta.byte_lengths),
            "crc32": meta.crc32,
            "payload_bytes": payload,
            "index_bytes": meta.index_bytes,
            "table_bytes": meta.payload_off - 24 - meta.index_bytes,
            "header_bytes": 24,
            "container_bytes": container.container_size(meta),
        }))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
