"""mhc — a Markov-Huffman compression framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jeremy-rifkin/Markov-Huffman-Coding (see SURVEY.md; the reference mount
was empty, so parity targets come from SURVEY.md/BASELINE.json):

* order-0 canonical Huffman and 256-context Markov-Huffman coding
* block-parallel encode/decode with per-block bit offsets (container.py)
* batched histogramming, vmapped tree-free table construction
* a GPU symbol-decode kernel (ops/decode_kernel.py)
* data-parallel sharding over a device mesh with psum histogram
  reduction, broadcast tables and ordered gather (parallel/)
"""

import os as _os

import jax as _jax

# Persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set (JAX
# reads it itself); otherwise one fixed directory inside the checkout, so
# every process started from it finds what an earlier one compiled.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".cache", "jax")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

from .api import (DEFAULT_BLOCK_SIZE, DEFAULT_DECODE_UNIT,
                  DEFAULT_SEGMENT_SIZE, compress, compress_file,
                  compression_report, decompress, decompress_file)
from .models.entropy import MARKOV, ORDER0, get_model

__version__ = "0.1.0"

__all__ = [
    "compress", "decompress", "compress_file", "decompress_file",
    "compression_report", "get_model", "ORDER0", "MARKOV",
    "DEFAULT_BLOCK_SIZE", "DEFAULT_DECODE_UNIT", "DEFAULT_SEGMENT_SIZE",
    "__version__",
]
