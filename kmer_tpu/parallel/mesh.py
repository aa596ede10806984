"""Device mesh helpers.

The reference has zero parallelism (single thread, single process —
SURVEY.md §2 parallelism inventory); the multi-chip story here is pure
jax.sharding: a Mesh with a "data" axis (reads sharded) and an optional
"seq" axis (long reads split across chips with halo exchange), with the
count-table merge riding all_to_all/psum over the device interconnect.
Devices are taken in plain jax.devices() order: on a host whose cards
are joined all to all (NVLink), every placement costs the same.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_mesh(n_data: int | None = None, n_seq: int = 1,
              devices=None) -> Mesh:
    """(n_data, n_seq) mesh; n_data defaults to all devices / n_seq."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_data is None:
        n_data = len(devices) // n_seq
    use = np.array(devices[: n_data * n_seq]).reshape(n_data, n_seq)
    return Mesh(use, (DATA_AXIS, SEQ_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(B, L) read batches: rows over data, columns over seq."""
    return NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """(B,) per-read vectors: rows over data, replicated over seq."""
    return NamedSharding(mesh, P(DATA_AXIS))
