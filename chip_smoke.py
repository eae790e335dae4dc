"""Smoke run of the codec on a GPU: the quickest proof that the main path
still starts, compiles and roundtrips on the card.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # phase 1, then the sharded path on 4 GPUs

One process holds the card the whole time: `serve` runs in a thread, the
CLI is called in-process, the GPU tests run through pytest.main. Phases:

1. device check: JAX must find a GPU, else exit non-zero before any
   codec work; print the device, JAX version, XLA_FLAGS, compile-cache
   directory and the card's name and power limit (nvidia-smi);
2. compile the symbol-decode kernel at real widths (markov du=8192,
   order-0 du=16384, 2,048 units each) and compare it byte for byte with
   the XLA scan decoder;
3. the main path on the 100 MB mixed corpus (BASELINE.json:9) in both
   modes: api, engine, container identity, size vs the C++ oracle, the
   CLI on a 1 MB file, the device-vs-host table build, `serve` over HTTP,
   and tests/test_gpu_chip.py;
4. timings after warm-up: kernel vs scan, the XLA alternatives that
   config.py chooses between, engine and api GB/s;
5. (--four only) compress_sharded/decompress_sharded over a 4-GPU mesh,
   compared byte for byte with the single-device container.

Every check raises; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, ".cache", "smoke")
CORPUS_MB = 100
KERNEL_UNITS = 2048          # units per kernel-vs-scan comparison
KERNEL_SHAPES = (("markov", 8192), ("huffman", 16384))
MODES = ("markov", "huffman")
MB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def best_time(fn, reps: int = 3) -> float:
    """Best wall time of fn() over `reps` runs after one warm-up, each
    ending in block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


class Timings:
    """Prints each timing beside the card's name and power limit."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, name: str, seconds: float, nbytes: int | None = None):
        rate = f"  {nbytes / seconds / 1e9:.3f} GB/s" if nbytes else ""
        log(f"timing {name}: {seconds * 1e3:.3f} ms{rate}  [{self.card}]")


# --------------------------------------------------------------- phase 1
def phase_device() -> dict:
    import jax

    from mhc.utils import device
    dev = device.require_gpu()
    for line in device.header():
        log(line)
    path = jax.config.jax_compilation_cache_dir
    n = len(os.listdir(path)) if os.path.isdir(path) else 0
    log(f"compile cache: {path} ({n} entries at start)")
    return dev


# --------------------------------------------------------------- phase 2
def kernel_case(corpus: bytes, mode: str, du: int, units: int):
    """(words, n_valid, tables, model) for `units` units of the corpus,
    packed by the XLA merge packer with the corpus tables."""
    import jax.numpy as jnp

    from mhc import api
    from mhc.models.entropy import get_model
    from mhc.ops import bitpack
    model = get_model(mode)
    blocks, nv = api.blockify(corpus[: units * du], du)
    tables, _ = api.build_tables(model, blocks, nv)
    words, bits = bitpack.encode_blocks_merge(
        jnp.asarray(blocks), jnp.asarray(nv), tables["codes"],
        tables["lengths"])
    max_w = int((int(bits.max()) + 31) // 32)
    W = min(words.shape[1], max(-(-(max_w + 1) // 128) * 128, 128))
    return words[:, :W], jnp.asarray(nv), tables, model


def phase_kernel(corpus: bytes, units: int = KERNEL_UNITS,
                 interpret: bool = False) -> dict:
    import numpy as np

    from mhc.ops import bitpack
    from mhc.ops.decode_kernel import decode_blocks_kernel
    cases = {}
    for mode, du in KERNEL_SHAPES:
        words, nv, t, model = kernel_case(corpus, mode, du, units)
        args = (words, nv, t["lim"], t["base"], t["first_code"],
                t["sorted_syms"])
        t0 = time.perf_counter()
        compiled = decode_blocks_kernel.lower(
            *args, n_out=du, markov=model.markov,
            interpret=interpret).compile()
        log(f"kernel {mode} du={du} C={words.shape[0]} W={words.shape[1]}"
            f" compiled in {time.perf_counter() - t0:.2f} s;"
            f" memory_analysis: {compiled.memory_analysis()}")
        got = np.asarray(compiled(*args))
        ref = np.asarray(bitpack.decode_blocks(*args, n_out=du,
                                               markov=model.markov))
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(
                f"kernel != scan ({mode}, du={du}): "
                f"{int((got != ref).sum())} bytes differ")
        log(f"kernel {mode} du={du}: equals scan byte for byte "
            f"({ref.size} bytes)")
        cases[mode] = (compiled, args, du, model)
    return cases


# --------------------------------------------------------------- phase 3
def post(url: str, data: bytes) -> bytes:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def phase_main_path(corpus: bytes, work_dir: str = WORK_DIR,
                    run_gpu_tests: bool = True) -> dict:
    import filecmp

    import jax.numpy as jnp
    import numpy as np

    import bench
    from mhc import api, cli, engine, serve
    from mhc.models.entropy import get_model
    from mhc.ops import huffman
    os.makedirs(work_dir, exist_ok=True)
    crc = zlib.crc32(corpus) & 0xFFFFFFFF
    corpus_path = bench.corpus_file(corpus, f"corpus_{len(corpus)}.bin")
    blobs = {}
    for mode in MODES:
        model = get_model(mode)
        blob = api.compress(corpus, mode=mode)
        if api.decompress(blob) != corpus:
            raise AssertionError(f"api roundtrip mismatch ({mode})")
        log(f"api {mode}: bit-exact roundtrip of {len(corpus)} bytes, "
            f"container {len(blob)} bytes")

        st = engine.stage(corpus, mode=mode)
        enc = engine.encode(st)
        if engine.fetch_bytes(enc, engine.decode(enc)) != corpus:
            raise AssertionError(f"engine roundtrip mismatch ({mode})")
        if engine.assemble_container(enc, crc) != blob:
            raise AssertionError(f"engine container != api container "
                                 f"({mode})")
        log(f"engine {mode}: bit-exact roundtrip; container equals api's")

        # table-broadcast invariant: the device builder (sharded path,
        # small engine inputs) and the host builder give identical codes
        counts = engine.histogram(st)
        host = np.asarray(model.lengths_from_counts(counts))
        dev = np.asarray(huffman.code_lengths(
            huffman.rescale_counts_jax(jnp.asarray(counts, jnp.int32))))
        if not np.array_equal(host, dev):
            raise AssertionError(f"device != host code lengths ({mode})")
        os.environ["MHC_TABLE_BUILD"] = "device"
        try:
            dev_blob = engine.assemble_container(engine.encode(st), crc)
        finally:
            del os.environ["MHC_TABLE_BUILD"]
        if dev_blob != blob:
            raise AssertionError(f"device-built container differs ({mode})")
        log(f"tables {mode}: device-built lengths == host-built lengths")

        ref = bench.oracle_baseline(corpus_path, mode)
        if len(blob) > ref["compressed_bytes"]:
            raise AssertionError(
                f"container {len(blob)} > oracle {ref['compressed_bytes']} "
                f"({mode})")
        log(f"oracle {mode}: container {len(blob)} <= oracle "
            f"{ref['compressed_bytes']} "
            f"(x{len(blob) / ref['compressed_bytes']:.6f})")
        blobs[mode] = blob
        del st, enc

    src = os.path.join(work_dir, "cli_in.bin")
    with open(src, "wb") as f:
        f.write(corpus[:MB])
    for mode in MODES:
        packed = os.path.join(work_dir, f"cli_{mode}.mhc")
        back = os.path.join(work_dir, f"cli_{mode}.out")
        if cli.main(["encode", "--mode", mode, src, packed]) != 0 \
                or cli.main(["decode", packed, back]) != 0:
            raise AssertionError(f"CLI failed ({mode})")
        if not filecmp.cmp(src, back, shallow=False):
            raise AssertionError(f"CLI roundtrip differs ({mode})")
        log(f"cli {mode}: encode/decode of 1 MB, cmp identical")

    srv, url = serve.start()
    try:
        for i in range(4):
            mode = MODES[i % 2]
            data = corpus[i * MB:(i + 1) * MB]
            blob = post(f"{url}/compress?mode={mode}", data)
            if post(f"{url}/decompress", blob) != data:
                raise AssertionError(f"serve roundtrip {i} differs")
        log("serve: 4 compress + 4 decompress requests, all exact")
    finally:
        srv.shutdown()

    if run_gpu_tests:
        import pytest
        os.environ["MHC_GPU_TESTS"] = "1"
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          os.path.join(REPO, "tests", "test_gpu_chip.py")])
        if rc != 0:
            raise AssertionError(f"tests/test_gpu_chip.py failed (rc {rc})")
        log("tests/test_gpu_chip.py: passed")
    return blobs


# --------------------------------------------------------------- phase 4
def phase_timings(corpus: bytes, cases: dict, blobs: dict, timing) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mhc import api, engine
    from mhc.models.entropy import get_model
    from mhc.ops import bitpack
    n = len(corpus)
    for mode, (compiled, args, du, model) in cases.items():
        nbytes = args[0].shape[0] * du
        timing(f"decode kernel {mode} du={du} C={args[0].shape[0]}",
               best_time(lambda: compiled(*args)), nbytes)
        timing(f"decode scan {mode} du={du} C={args[0].shape[0]}",
               best_time(lambda: bitpack.decode_blocks(
                   *args, n_out=du, markov=model.markov)), nbytes)

    for mode in MODES:
        blob = blobs[mode]
        for method in ("pallas", "scan"):
            timing(f"api.decompress {mode} {method} {n >> 20} MB",
                   best_time(lambda: api.decompress(
                       blob, decode_method=method), reps=2), n)
        timing(f"api.compress {mode} {n >> 20} MB",
               best_time(lambda: api.compress(corpus, mode=mode), reps=2), n)

        st = engine.stage(corpus, mode=mode)
        timing(f"engine.encode {mode}",
               best_time(lambda: engine.encode(st).payload, reps=2), n)
        enc = engine.encode(st)
        timing(f"engine.decode {mode}",
               best_time(lambda: engine.decode(enc), reps=2), n)

        model = get_model(mode)
        chunks = list(zip(st.units, st.n_valid))
        for m in ("scatter", "matmul"):
            timing(f"histogram {mode} {m}", best_time(lambda: [
                model.histogram(u, v, method=m) for u, v in chunks]), n)
        t = model.tables_from_lengths(enc.lengths)
        for name, fn in (("merge", bitpack.encode_blocks_merge),
                         ("scatter", bitpack.encode_blocks)):
            timing(f"pack {mode} {name}", best_time(lambda: [
                fn(u, v, t["codes"], t["lengths"]) for u, v in chunks]), n)

        words, bits = bitpack.encode_blocks_merge(
            st.units[0], st.n_valid[0], t["codes"], t["lengths"])
        wl = (np.asarray(bits).astype(np.int64) + 31) // 32
        offs = np.zeros(len(wl) + 1, np.int32)
        np.cumsum(wl, out=offs[1:])
        pad = max(-(-int(offs[-1]) // (1 << 18)) << 18, 1 << 18)
        offs_d, wl_d = jnp.asarray(offs), jnp.asarray(wl.astype(np.int32))
        W = words.shape[1]
        payload = bitpack.device_compact_words(words, offs_d, pad)
        for name, fn in (("slices", bitpack.device_compact_words_slices),
                         ("gather", bitpack.device_compact_words),
                         ("blocks", bitpack.device_compact_words_blocks)):
            timing(f"compact {mode} {name} C={words.shape[0]}",
                   best_time(lambda: fn(words, offs_d, pad)))
        for name, fn in (("slices", bitpack.device_expand_words_slices),
                         ("gather", bitpack.device_expand_words_u32),
                         ("blocks", bitpack.device_expand_words_blocks)):
            timing(f"expand {mode} {name} C={words.shape[0]}",
                   best_time(lambda: fn(payload, offs_d, wl_d, W)))
        del st, enc, words, payload

    x = jax.block_until_ready(jnp.ones((n,), jnp.uint8))
    timing("d2h copy", best_time(lambda: np.asarray(x + 0)), n)


# --------------------------------------------------------------- phase 5
def phase_four(corpus: bytes, timing, mesh_devices: int = 4) -> None:
    from mhc import api
    from mhc.parallel import mesh as meshmod
    from mhc.parallel import pipeline
    mesh = meshmod.make_mesh(mesh_devices)
    for mode in MODES:
        ref = api.compress(corpus, mode=mode)
        blob = pipeline.compress_sharded(corpus, mesh, mode=mode)
        if blob != ref:
            raise AssertionError(f"sharded container != single-device "
                                 f"container ({mode})")
        if pipeline.decompress_sharded(blob, mesh) != corpus:
            raise AssertionError(f"sharded roundtrip mismatch ({mode})")
        log(f"sharded {mode} x{mesh_devices}: container equals the "
            f"single-device one ({len(blob)} bytes); roundtrip exact")
        n = len(corpus)
        timing(f"compress_sharded {mode} x{mesh_devices}", best_time(
            lambda: pipeline.compress_sharded(corpus, mesh, mode=mode),
            reps=2), n)
        timing(f"decompress_sharded {mode} x{mesh_devices}", best_time(
            lambda: pipeline.decompress_sharded(blob, mesh), reps=2), n)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path on a 4-GPU mesh")
    args = p.parse_args(argv)

    dev = phase_device()
    sys.path.insert(0, REPO)
    import bench
    from mhc.utils import device
    timing = Timings(device.card())
    t0 = time.perf_counter()
    corpus = bench.make_corpus(CORPUS_MB * MB)
    log(f"corpus: {len(corpus)} bytes in {time.perf_counter() - t0:.1f} s")
    if args.four:
        if dev["count"] < 4:
            raise SystemExit(f"--four needs 4 GPUs, JAX found {dev['count']}")
        phase_four(corpus, timing)
        count = 4
    else:
        cases = phase_kernel(corpus)
        blobs = phase_main_path(corpus)
        phase_timings(corpus, cases, blobs, timing)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
