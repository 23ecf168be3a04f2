"""Device mesh + sharding helpers — the communication layer.

The reference's only distribution strategy is data parallelism via
pthread-per-GPU replicas with periodic PCIe weight averaging
(`network_kernels.cu:295-484`, SURVEY.md §2.7).  The equivalent here is a
`jax.sharding.Mesh` with the batch dimension sharded over the `dp` axis:
XLA inserts per-step gradient all-reduces (NCCL over NVLink) — strictly
stronger than 4-iter weight averaging (and BN statistics become global
across replicas, i.e. sync-BN, matching the single-card math exactly).
The mesh is flat: NVLink joins every card to every other at one rate.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_batch(mesh: Mesh, x, axis: str = "dp"):
    """Place an array with its leading (batch) dim sharded over the mesh."""
    spec = P(axis)
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree over the mesh."""
    s = NamedSharding(mesh, P())
    return jax.device_put(tree, s)


def round_batch_to_mesh(batch: int, n_dp: int) -> int:
    """Smallest adjustment of an inference batch so it divides over a
    dp-sharded serving mesh (Network._serve_shardings requires batch %
    n_dp == 0): at least n_dp, rounded down to a multiple.  Shared by
    mode_valid's -num_chips path and the trainer's in-training mAP."""
    batch = max(batch, n_dp)
    return batch - batch % n_dp
