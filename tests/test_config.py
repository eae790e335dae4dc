"""One platform rule in one place (mhc/config.py), the compile-cache
placement, and the GPU-only entry points refusing to run on the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from mhc import api, config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = {"decode": "MHC_DECODE_METHOD", "pack": "MHC_PACK_METHOD",
        "hist": "MHC_HIST_METHOD", "expand": "MHC_EXPAND_IMPL",
        "compact": "MHC_COMPACT_IMPL"}


@pytest.fixture
def clean_env(monkeypatch):
    for var in list(_ENV.values()) + ["MHC_CHUNK_MB"]:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("backend,decoder", [("gpu", "pallas"),
                                             ("cpu", "scan")])
def test_platform_rule(clean_env, backend, decoder):
    clean_env.setattr(config.jax, "default_backend", lambda: backend)
    assert config.decode_method() == decoder
    assert config.platform_defaults()["decode"] == decoder


@pytest.mark.parametrize("backend", ["metal", "plugin_x"])
def test_unknown_backend_raises(clean_env, backend):
    clean_env.setattr(config.jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no implementation table"):
        config.decode_method()
    with pytest.raises(RuntimeError, match="no implementation table"):
        config.chunk_mb()


@pytest.mark.parametrize("key,value", [
    ("decode", "pallas"), ("pack", "scatter"), ("hist", "matmul"),
    ("expand", "blocks"), ("compact", "slices")])
def test_env_overrides_default(clean_env, key, value):
    clean_env.setenv(_ENV[key], value)
    fn = {"decode": config.decode_method, "pack": config.pack_method,
          "hist": config.hist_method, "expand": config.expand_impl,
          "compact": config.compact_impl}[key]
    assert fn() == value


def test_chunk_mb_override(clean_env):
    assert config.chunk_mb() == config.platform_defaults("cpu")["chunk_mb"]
    clean_env.setenv("MHC_CHUNK_MB", "3")
    assert config.chunk_mb() == 3
    assert api._chunk_units(8192) == (3 << 20) // 8192


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_defaults_name_real_implementations(backend):
    d = config.platform_defaults(backend)
    api.decode_fn(d["decode"])
    api._packer(d["pack"])
    assert d["hist"] in ("scatter", "matmul")
    assert d["expand"] in ("slices", "gather", "blocks")
    assert d["compact"] in ("slices", "gather", "blocks")
    assert d["chunk_mb"] > 0


def _cache_dir(env_extra: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "import mhc, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_in_checkout():
    assert _cache_dir({}) == os.path.join(REPO, ".cache", "jax")


def test_compile_cache_env_wins(tmp_path):
    want = str(tmp_path / "cc")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_require_gpu_refuses_cpu():
    from mhc.utils import device
    assert device.describe()["platform"] == "cpu"
    with pytest.raises(SystemExit):
        device.require_gpu()


def test_chip_smoke_exits_nonzero_on_cpu(capsys):
    import chip_smoke
    with pytest.raises(SystemExit) as ei:
        chip_smoke.main([])
    assert ei.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_without_gpu(capsys):
    import bench
    with pytest.raises(SystemExit) as ei:
        bench.main()
    assert ei.value.code not in (0, None)
    assert capsys.readouterr().out == ""
