"""Serving daemon: in-process HTTP roundtrip + error paths."""

import urllib.request
import urllib.error

import pytest

from mhc import serve
from tests.corpus import english_like


@pytest.fixture(scope="module")
def server():
    srv, url = serve.start()
    yield url
    srv.shutdown()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def test_http_roundtrip(server):
    data = english_like(50_000, seed=55)
    blob = _post(server + "/compress?mode=markov&block_size=4096", data)
    assert len(blob) < len(data)
    back = _post(server + "/decompress", blob)
    assert back == data


def test_http_bad_input_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server + "/decompress", b"not a container")
    assert ei.value.code == 400


def test_stats_and_health(server):
    import json
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    with urllib.request.urlopen(server + "/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["requests"] >= 2


def test_decompress_uses_platform_default_and_reports_rate(server):
    """/decompress with no ?method must follow the platform rule
    (config.decode_method) instead of a hard-coded decoder, and every
    codec response carries a throughput header."""
    data = english_like(30_000, seed=56)
    blob = _post(server + "/compress?mode=markov&block_size=4096", data)
    req = urllib.request.Request(server + "/decompress", data=blob,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.read() == data
        assert float(r.headers["X-MHC-Seconds"]) > 0
        assert float(r.headers["X-MHC-MBps"]) > 0
    import json
    with urllib.request.urlopen(server + "/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["codec_seconds"] > 0 and st["codec_MBps"] > 0
