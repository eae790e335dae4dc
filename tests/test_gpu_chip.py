"""On-card regression tests (marked `gpu`): the default path must compile
and roundtrip on the GPU at the shipped shapes, so a kernel that cannot
compile at the default configuration fails here. On the CPU the `gpu`
fixture skips them; `python chip_smoke.py` runs them on the card:

    MHC_GPU_TESTS=1 python -m pytest tests/test_gpu_chip.py -m gpu -q

Test corpora come from `corpus` (tests/ is on sys.path under pytest): a
site-packages `tests` package may shadow `tests.corpus` on a GPU host.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def corpus16():
    from bench import make_corpus
    return make_corpus(16 << 20)


def test_platform_rule_picks_kernel(gpu):
    from mhc import config
    assert config.platform_defaults()["decode"] == "pallas"
    assert config.decode_method() == "pallas"


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_api_roundtrip_default(gpu, corpus16, mode):
    """Default path at bench shapes: the GPU decode kernel at the shipped
    decode unit and chunking."""
    from mhc import api
    blob = api.compress(corpus16, mode=mode)
    assert api.decompress(blob) == corpus16
    assert api.decompress(blob, decode_method="scan") == corpus16


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_engine_roundtrip_and_container(gpu, corpus16, mode):
    import zlib
    from mhc import api, engine
    st = engine.stage(corpus16, mode=mode)
    enc = engine.encode(st)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == corpus16
    assert engine.assemble_container(
        enc, zlib.crc32(corpus16) & 0xFFFFFFFF) == api.compress(
            corpus16, mode=mode)


def test_engine_repacked_decode(gpu):
    """Literal units skipped by the kernel (repack) with several chunks."""
    from mhc import engine
    rng = np.random.default_rng(5)
    from corpus import english_like
    data = (english_like(3 << 20, seed=4)
            + rng.integers(0, 256, 2 << 20, dtype=np.uint8).tobytes())
    st = engine.stage(data, mode="huffman", decode_unit=2048,
                      chunk_units=512)
    enc = engine.encode(st)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data


def test_kernel_ragged_rows(gpu):
    """B not a multiple of the lanes, ragged and empty rows, on the card."""
    import jax.numpy as jnp
    from mhc import api
    from mhc.models.entropy import get_model
    from mhc.ops import bitpack
    from mhc.ops.decode_kernel import LANES, decode_blocks_kernel
    from corpus import mixed_binary
    model = get_model("markov")
    units, nv = api.blockify(mixed_binary((3 * LANES + 7) * 4096), 4096)
    nv = nv.copy()
    nv[3] = 0
    nv[5] = 17
    tables, _ = api.build_tables(model, units, nv)
    words, _ = bitpack.encode_blocks(jnp.asarray(units), jnp.asarray(nv),
                                     tables["codes"], tables["lengths"])
    args = (words, jnp.asarray(nv), tables["lim"], tables["base"],
            tables["first_code"], tables["sorted_syms"])
    ref = bitpack.decode_blocks(*args, n_out=4096)
    got = decode_blocks_kernel(*args, n_out=4096)
    assert np.array_equal(np.asarray(got), np.asarray(ref))


def test_sharded_pipeline_one_device_mesh(gpu, corpus16):
    """The sharded driver with the kernel per shard on a 1-device mesh
    is byte-identical to the single-device container."""
    from mhc import api
    from mhc.parallel import mesh as meshmod
    from mhc.parallel import pipeline
    data = corpus16[: 4 << 20]
    mesh = meshmod.make_mesh(1)
    blob = pipeline.compress_sharded(data, mesh, mode="markov")
    assert blob == api.compress(data, mode="markov")
    assert pipeline.decompress_sharded(blob, mesh) == data
