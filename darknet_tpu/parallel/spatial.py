"""Spatial partitioning — the CNN analogue of sequence/context parallelism
(SURVEY.md §2.7/§5): shard the feature maps' H dimension across the mesh for
inputs too large for one card's HBM (608^2+, batched video).

Design: annotate the input NHWC array with `P(None, "sp")` (H
sharded) and jit the same emitted forward — XLA's GSPMD partitioner inserts
the conv halo exchanges (`CollectivePermute` of the kernel-overlap rows)
automatically.  This replaces hand-written halo machinery; the
mesh axis is the single source of truth.

Composes with data parallelism: a 2D mesh ("dp", "sp") shards batch on dp
and height on sp.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_spatial_mesh(n_dp: int, n_sp: int) -> Mesh:
    devices = np.array(jax.devices()[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devices, ("dp", "sp"))


def make_spatial_forward(graph, mesh, *, compute_dtype=None,
                         fused_bn: bool = True, decode: bool = True):
    """Jitted inference fn with batch sharded over `dp` and H over `sp`.

    Returns `fn(params, x) -> (boxes, obj, cls)` (decoded) or the raw head
    list.  Output detections are replicated (gathered) — they are tiny.
    """
    import jax.numpy as jnp

    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.ops import yolo as yoloops

    fwd = make_forward(graph, compute_dtype=compute_dtype, fused_bn=fused_bn)
    heads = [l for l in graph.heads() if l.kind in ("yolo", "gaussian_yolo")]
    net_w, net_h = graph.net.w, graph.net.h

    def run(params, x):
        r = fwd(params, x)
        if not decode:
            return r["heads"]
        outs = []
        for t, l in zip(r["heads"], heads):
            t = t.astype(jnp.float32)
            if l.kind == "yolo":
                b, o, c = yoloops.yolo_decode(t, l, net_w, net_h)
            else:
                b, o, c, _ = yoloops.gaussian_yolo_decode(t, l, net_w, net_h)
            outs.append((b, o, c))
        boxes = jnp.concatenate([o[0] for o in outs], axis=1)
        obj = jnp.concatenate([o[1] for o in outs], axis=1)
        cls = jnp.concatenate([o[2] for o in outs], axis=1)
        return boxes, obj, cls

    rep = NamedSharding(mesh, P())
    x_sharding = NamedSharding(mesh, P("dp", "sp", None, None))
    return jax.jit(run, in_shardings=(rep, x_sharding),
                   out_shardings=rep)


def shard_spatial(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("dp", "sp", None, None)))
