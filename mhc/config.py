"""Central resolution of every implementation choice.

Every choice that depends on the platform is made HERE, once, from
`jax.default_backend()`, and passed down to the drivers (api / engine /
serve / pipeline) as explicit static arguments: kernels never read
os.environ at trace time (an env var read inside a jitted function
freezes at first trace).

Platform rule: `gpu` runs the Pallas symbol-decode kernel
(ops/decode_kernel.py) and the XLA forms chosen below; `cpu` runs the
XLA scan decoder and the CPU forms. Any other backend is an error.

Env overrides (see CLAUDE.md):
  MHC_DECODE_METHOD  scan | pallas
  MHC_PACK_METHOD    merge | scatter
  MHC_HIST_METHOD    scatter | matmul
  MHC_EXPAND_IMPL    slices | gather | blocks  (payload word expansion)
  MHC_COMPACT_IMPL   slices | gather | blocks  (payload compaction)
  MHC_CHUNK_MB       input MB per device batch
  MHC_TABLE_BUILD    auto | host | device (engine.encode table build,
                     read in engine.py / models/entropy.py; bit-identical
                     either way)
"""

from __future__ import annotations

import os

import jax

# Per-platform defaults. GPU values were chosen from one timing of each
# alternative on an H100 at 100 MB (chip_smoke.py phase 4; CHANGES.md
# records the numbers): scatter pack ~7x merge, scatter histogram ~4x
# matmul over both modes, gather expand and blocks compact (slices, a
# scan of C/4 steps, is ~50x slower there). 128 MB chunks put a 100 MB
# input in one decode launch, which keeps every SM busy.
_DEFAULTS = {
    "gpu": {"decode": "pallas", "pack": "scatter", "hist": "scatter",
            "expand": "gather", "compact": "blocks", "chunk_mb": 128},
    "cpu": {"decode": "scan", "pack": "merge", "hist": "scatter",
            "expand": "slices", "compact": "gather", "chunk_mb": 16},
}


def platform_defaults(backend: str | None = None) -> dict:
    """The implementation table for `backend` (default: JAX's)."""
    backend = backend or jax.default_backend()
    try:
        return _DEFAULTS[backend]
    except KeyError:
        raise RuntimeError(
            f"mhc: no implementation table for JAX backend {backend!r} "
            f"(supported: {sorted(_DEFAULTS)})") from None


def _choice(env: str, key: str) -> str:
    return os.environ.get(env) or platform_defaults()[key]


def decode_method() -> str:
    return _choice("MHC_DECODE_METHOD", "decode")


def pack_method() -> str:
    return _choice("MHC_PACK_METHOD", "pack")


def hist_method() -> str:
    return _choice("MHC_HIST_METHOD", "hist")


def expand_impl() -> str:
    return _choice("MHC_EXPAND_IMPL", "expand")


def compact_impl() -> str:
    return _choice("MHC_COMPACT_IMPL", "compact")


def chunk_mb() -> int:
    """Input MB per device batch. The GPU decode kernel runs one warp per
    32 unit streams, so a batch has to hold many thousand units before
    every SM has warps to switch between."""
    return int(os.environ.get("MHC_CHUNK_MB")
               or platform_defaults()["chunk_mb"])
