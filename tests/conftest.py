"""Test config: an 8-device CPU mesh unless MHC_GPU_TESTS=1.

By default every test runs on the CPU, with 8 virtual devices for the
sharded tests. Tests marked `gpu` (tests/test_gpu_chip.py) need the card:
their `gpu` fixture skips them when JAX finds no GPU. `python
chip_smoke.py` runs them on the card in its own process with
MHC_GPU_TESTS=1, which leaves JAX's platform alone:

    MHC_GPU_TESTS=1 python -m pytest tests/test_gpu_chip.py -m gpu -q
"""

import os
import sys

import jax
import pytest

if os.environ.get("MHC_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; python chip_smoke.py runs these on the card")
