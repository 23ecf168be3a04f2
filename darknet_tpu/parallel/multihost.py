"""Multi-host (DCN) input sharding.

Single-host meshes feed `shard_batch` directly; on a multi-host cluster
each process loads only its local shard of the global batch and assembles
the global array with `jax.make_array_from_process_local_data` — the
equivalent of the reference's `GetPartialData` pointer split
(data.cpp:890-901), with DCN handling the cross-host layout.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def process_batch_slice(global_batch: int) -> tuple:
    """(start, size) of this process's share of the global batch."""
    n = jax.process_count()
    i = jax.process_index()
    per = global_batch // n
    return i * per, per


def make_global_batch(mesh: Mesh, local_x: np.ndarray, axis: str = "dp"):
    """Assemble a globally-sharded array from per-process local data.

    `local_x` is this host's slice (leading dim = global_batch /
    process_count).  Returns a jax.Array sharded over `axis`.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_x)
