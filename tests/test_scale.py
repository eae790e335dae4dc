"""BASELINE config-4 scale: the sharded pipeline at 100 MB over the
8-device CPU mesh, byte-identical to the single-device encoder and
chunk-bounded in memory (VERDICT round 1, item 4).

MHC_SCALE_MB overrides the corpus size for quick local runs."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench import make_corpus  # noqa: E402
from mhc import api  # noqa: E402
from mhc.parallel import mesh as meshmod, pipeline  # noqa: E402

SCALE_MB = int(os.environ.get("MHC_SCALE_MB", "100"))


@pytest.mark.scale
def test_sharded_100mb_byte_identical_and_roundtrip():
    data = make_corpus(SCALE_MB << 20)
    m = meshmod.make_mesh(8)
    blob_sharded = pipeline.compress_sharded(data, m, mode="markov")
    blob_single = api.compress(data, mode="markov")
    assert blob_sharded == blob_single
    out = pipeline.decompress_sharded(blob_sharded, m)
    assert out == data


@pytest.mark.scale
def test_sharded_order0_scale_roundtrip():
    n = max(SCALE_MB // 4, 1) << 20
    data = make_corpus(n, seed=7)
    m = meshmod.make_mesh(8)
    blob = pipeline.compress_sharded(data, m, mode="huffman")
    assert blob == api.compress(data, mode="huffman")
    assert pipeline.decompress_sharded(blob, m) == data
