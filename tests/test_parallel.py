"""Distributed-logic tests on the 8-device CPU mesh (SURVEY.md §4:
'Distributed without a real cluster'). Exercises psum histogram reduction,
replicated table construction, sharded block encode/decode, ordered gather."""

import jax
import numpy as np
import pytest

from mhc import api
from mhc.ops import huffman
from mhc.parallel import mesh as meshmod
from mhc.parallel import pipeline
from tests.corpus import english_like, mixed_binary


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return meshmod.make_mesh(8)


def test_mesh_has_8_devices(mesh8):
    assert mesh8.shape["data"] == 8


@pytest.mark.parametrize("mode", ["huffman", "markov"])
def test_sharded_roundtrip(mesh8, mode):
    data = english_like(300_000, seed=3)
    blob = pipeline.compress_sharded(data, mesh8, mode=mode, block_size=4096)
    out = pipeline.decompress_sharded(blob, mesh8)
    assert out == data


def test_sharded_equals_single_process(mesh8):
    """The sharded pipeline must produce byte-identical containers to the
    single-device path — tables are deterministic and blocks are gathered
    in order, so the container is a pure function of the input."""
    data = mixed_binary(200_000, seed=11)
    blob_sharded = pipeline.compress_sharded(data, mesh8, mode="markov",
                                             block_size=4096)
    blob_local = api.compress(data, mode="markov", block_size=4096)
    assert blob_sharded == blob_local


def test_sharded_decode_of_local_container(mesh8):
    data = english_like(150_000, seed=4)
    blob = api.compress(data, mode="markov", block_size=4096)
    assert pipeline.decompress_sharded(blob, mesh8) == data


def test_local_decode_of_sharded_container(mesh8):
    data = english_like(150_000, seed=5)
    blob = pipeline.compress_sharded(data, mesh8, mode="markov",
                                     block_size=4096)
    assert api.decompress(blob) == data


def test_block_count_not_divisible_by_shards(mesh8):
    # 5 blocks over 8 shards: padding with empty blocks must be invisible
    data = english_like(5 * 4096, seed=6)
    blob = pipeline.compress_sharded(data, mesh8, mode="markov",
                                     block_size=4096)
    assert pipeline.decompress_sharded(blob, mesh8) == data


def test_tiny_input_on_mesh(mesh8):
    for payload in (b"", b"x", b"xy" * 3):
        blob = pipeline.compress_sharded(payload, mesh8, mode="markov")
        assert pipeline.decompress_sharded(blob, mesh8) == payload


def test_rescale_jax_matches_numpy():
    # int32 totals are the contract: per-context totals must stay < 2**31
    # (multi-GB corpora get segmented containers upstream)
    rng = np.random.default_rng(0)
    for scale in (1, 10 ** 3, 7000):
        counts = (rng.integers(0, 1000, (16, 256)) * scale).astype(np.int32)
        assert counts.astype(np.int64).sum(axis=-1).max() < 2 ** 31
        a = huffman.rescale_counts(counts)
        b = np.array(huffman.rescale_counts_jax(counts))
        assert (a == b).all()
    # boundary: totals straddling the 2**28 rescale threshold
    for total_target in (2 ** 28 - 256, 2 ** 28 + 256, 2 ** 30 + 12345):
        counts = np.full((1, 256), total_target // 256, np.int32)
        counts[0, 0] += total_target - int(counts.sum())
        a = huffman.rescale_counts(counts)
        b = np.array(huffman.rescale_counts_jax(counts))
        assert (a == b).all()


def test_sharded_pallas_decode_matches_scan(mesh8):
    """The sharded decoder runs the GPU decode kernel per shard
    (interpret mode on the CPU mesh) — must be byte-identical to the
    scan path and to the original input."""
    data = mixed_binary(300_000, seed=21)
    blob = pipeline.compress_sharded(data, mesh8, mode="markov",
                                     block_size=4096)
    out_scan = pipeline.decompress_sharded(blob, mesh8,
                                           decode_method="scan")
    out_pallas = pipeline.decompress_sharded(blob, mesh8,
                                             decode_method="pallas",
                                             interpret=True)
    assert out_scan == data
    assert out_pallas == data
