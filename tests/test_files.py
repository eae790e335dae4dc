"""File-level API: segment chaining, CLI paths, sharded file mode."""

import json
import os

import numpy as np
import pytest

from mhc import api
from mhc.cli import main as cli_main
from tests.corpus import english_like, mixed_binary


@pytest.fixture
def tmpfiles(tmp_path):
    def mk(name, data):
        p = tmp_path / name
        p.write_bytes(data)
        return str(p)
    return mk, tmp_path


def test_segment_chaining_roundtrip(tmpfiles):
    mk, tmp = tmpfiles
    data = mixed_binary(700_000, seed=31)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    back = str(tmp / "back.bin")
    rep = api.compress_file(src, dst, segment_size=200_000)
    assert rep["n_segments"] == 4
    rep2 = api.decompress_file(dst, back)
    assert rep2["n_segments"] == 4
    assert open(back, "rb").read() == data


def test_single_segment_file(tmpfiles):
    mk, tmp = tmpfiles
    data = english_like(100_000, seed=32)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    back = str(tmp / "back.bin")
    api.compress_file(src, dst)
    api.decompress_file(dst, back)
    assert open(back, "rb").read() == data


def test_empty_file(tmpfiles):
    mk, tmp = tmpfiles
    src = mk("in.bin", b"")
    dst = str(tmp / "out.mhc")
    back = str(tmp / "back.bin")
    rep = api.compress_file(src, dst)
    assert rep["n_segments"] == 1
    api.decompress_file(dst, back)
    assert open(back, "rb").read() == b""


def test_sharded_file_mode(tmpfiles):
    from mhc.parallel import mesh as meshmod
    mk, tmp = tmpfiles
    data = english_like(300_000, seed=33)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    back = str(tmp / "back.bin")
    m = meshmod.make_mesh(8)
    api.compress_file(src, dst, sharded=True, mesh=m,
                      segment_size=150_000)
    api.decompress_file(dst, back, sharded=True, mesh=m)
    assert open(back, "rb").read() == data


def test_cli_segmented_roundtrip(tmpfiles, capsys):
    mk, tmp = tmpfiles
    data = english_like(250_000, seed=34)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    back = str(tmp / "back.bin")
    rc = cli_main(["encode", "--segment-size", "100K", "--report",
                   src, dst])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["n_segments"] == 3
    rc = cli_main(["decode", "--report", dst, back])
    assert rc == 0
    assert open(back, "rb").read() == data


def test_cli_stat_default_container(tmpfiles, capsys):
    """`mhc stat` must report nonzero payload for the default sub-stream
    layout (round-1 regression: it summed the empty bit_lengths)."""
    mk, tmp = tmpfiles
    data = english_like(120_000, seed=35)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    rc = cli_main(["encode", src, dst])
    assert rc == 0
    capsys.readouterr()
    rc = cli_main(["stat", dst])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["payload_bytes"] > 0
    assert rep["orig_len"] == len(data)
    assert rep["decode_unit"] > 0
    assert rep["n_units"] >= rep["n_blocks"]
    assert (rep["header_bytes"] + rep["index_bytes"] + rep["table_bytes"]
            + rep["payload_bytes"]) <= rep["container_bytes"] + 8


def test_streaming_segment_reader(tmpfiles):
    """decompress_file must not buffer the whole file: _next_segment reads
    incrementally and every read is bounded by one segment."""
    mk, tmp = tmpfiles
    data = mixed_binary(900_000, seed=36)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    rep = api.compress_file(src, dst, segment_size=300_000)
    assert rep["n_segments"] == 3
    file_size = os.path.getsize(dst)

    class RecordingFile:
        def __init__(self, f):
            self.f = f
            self.reads = []

        def read(self, n=-1):
            b = self.f.read(n)
            self.reads.append(len(b))
            return b

    segs = []
    with open(dst, "rb") as raw:
        f = RecordingFile(raw)
        carry = b""
        while True:
            seg, carry = api._next_segment(f, carry)
            if seg is None:
                break
            segs.append(seg)
    assert len(segs) == 3
    assert sum(len(s) for s in segs) == file_size
    # every single read is far below the whole file size
    assert max(f.reads) < file_size
    # and the segments decode correctly
    out = b"".join(api.decompress(s) for s in segs)
    assert out == data
