"""Device mesh helpers.

The reference has no communication layer at all (SURVEY.md §2b); scaling
in this framework is data-parallelism over compression blocks on a 1-axis
`jax.sharding.Mesh` (BASELINE.json:10-11). The cards of one host are
joined all to all, so one axis is the whole topology. Multiple hosts
extend the same axis across processes via `jax.distributed.initialize` —
the program is identical; XLA hands the psum to NCCL.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def block_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Blocks batch dim sharded across the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(B: int, n_shards: int) -> int:
    return (B + n_shards - 1) // n_shards * n_shards
