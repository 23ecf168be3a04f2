"""Data-parallel training step over a device mesh.

One logical jitted program with the batch sharded over the `dp` axis and
parameters replicated; XLA partitions the conv FLOPs per device and inserts
`psum` all-reduces (NCCL over NVLink on the GPU) for the parameter gradients and the (global)
batch-norm statistics.  This subsumes the reference's TrainNetworks /
SyncNetworks machinery (`network_kernels.cu:295-484`) with per-step exact
synchronization.

Note on LR: the reference multiplies LR by the GPU count and keeps the
per-replica batch (`detector.cpp:67`).  Here the caller passes the global
batch through `[net] batch`; if you want reference-equivalent scaling when
growing the mesh, scale the cfg LR the same way (documented, not implicit).
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from darknet_tpu.train.step import make_train_step


def make_dp_train_step(graph, mesh, *, axis: str = "dp", compute_dtype=None,
                       donate: bool = True, accum: int = 1,
                       remat: bool = False, train_act_dtype=None):
    """Jitted DP train step: params/opt replicated, batch sharded.

    accum>1 composes subdivision gradient accumulation (train/step.py)
    with DP: micro-batches are interleaved across the batch dim, so each
    scan step processes an equal local slice on every dp shard; the
    gradient all-reduce happens once, on the accumulated gradients."""
    inner = make_train_step(graph, compute_dtype=compute_dtype, jit=False,
                            accum=accum, remat=remat,
                            train_act_dtype=train_act_dtype)

    # each micro-batch must split evenly across the dp shards — an uneven
    # split wouldn't fail, but XLA would silently reshard every scan step
    # (communication per micro-batch instead of one psum at the end)
    b = graph.net.optimizer_batch
    n_dp = mesh.shape[axis]
    if accum >= 1 and b % max(accum, 1) == 0:
        micro = b // max(accum, 1)
        assert micro % n_dp == 0, (
            f"micro-batch {micro} (= batch {b} / subdivisions {accum}) "
            f"must divide evenly across the {n_dp}-device '{axis}' axis")

    rep = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P(axis))

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(
        inner,
        in_shardings=(rep, rep, dp, dp, rep, rep),
        out_shardings=(rep, rep, rep, rep),
        donate_argnums=donate_argnums,
    )
