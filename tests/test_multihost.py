"""True multi-process 'multi-host' validation: two OS processes, each
with 4 CPU devices, form one 8-device jax.distributed mesh and run the
sharded codec end-to-end. The container produced under multi-host
sharding must be byte-identical to the single-process container — the
cross-host determinism contract (BASELINE.json:11)."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r'''
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_compilation_cache", False)
jax.distributed.initialize(coordinator_address="127.0.0.1:%(port)d",
                           num_processes=2, process_id=%(pid)d)
import numpy as np
from jax.sharding import Mesh
from mhc.parallel import pipeline
from tests_corpus_stub import english_like

data = english_like(96 * 1024, seed=9)
mesh = Mesh(np.array(jax.devices()), ("data",))
blob = pipeline.compress_sharded(data, mesh, mode="markov",
                                 block_size=16384, decode_unit=2048)
out = pipeline.decompress_sharded(blob, mesh)
assert out == data, "multihost roundtrip mismatch"
sys.stdout.write("BLOBHASH %%s\n" %% __import__("hashlib").sha256(blob).hexdigest())
sys.stdout.flush()
'''


@pytest.mark.slow
def test_two_process_mesh_matches_single_process(tmp_path):
    # free port
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    # corpus helper importable by workers without pytest machinery
    stub = tmp_path / "tests_corpus_stub.py"
    stub.write_text(
        open(os.path.join(REPO, "tests", "corpus.py")).read())

    procs = []
    for pid in range(2):
        code = _WORKER % {"repo": REPO, "port": port, "pid": pid}
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{tmp_path}:{REPO}"
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(out)
    hashes = [line.split()[1] for out in outs for line in out.splitlines()
              if line.startswith("BLOBHASH")]
    assert len(hashes) == 2 and hashes[0] == hashes[1]

    # compare against the single-process container
    import hashlib

    from mhc import api
    from tests.corpus import english_like
    data = english_like(96 * 1024, seed=9)
    blob_local = api.compress(data, mode="markov", block_size=16384,
                              decode_unit=2048)
    assert hashlib.sha256(blob_local).hexdigest() == hashes[0]
