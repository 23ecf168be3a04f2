"""Tensor (model) parallelism — shard conv filters over a mesh axis.

The reference scales only by replicating whole networks per GPU
(SURVEY.md §2.7: `SyncNetworks` weight averaging, `network_kernels.cu`);
it has no model-parallel mode.  The idiomatic extension is GSPMD
tensor parallelism: annotate each conv's HWIO weight with
``P(None, None, None, "tp")`` (output-channel sharded) and its per-filter
vectors (bias, BN scales/rolling stats, int8 w_scale) with ``P("tp")``,
then jit the SAME emitted forward/train step over the mesh — XLA's
partitioner gives every device its slice of the filters and inserts the
activation all-gathers.  Params, gradients AND optimizer slots
all live sharded (a Megatron-style split composed with the ZeRO-style
memory win), so the per-device HBM footprint of weights+opt shrinks by
the tp factor — the enabler for cfg models wider than one card.

Eligibility: plain convs (groups == 1, no share_index) whose filter count
divides the axis size.  Head convs (n = anchors*(classes+5), usually
indivisible) and every other layer kind stay replicated — GSPMD re-shards
at the boundary automatically.  Composes with data parallelism ("dp"
batch axis) and spatial sharding ("sp" height axis) in one mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_tp_mesh(n_dp: int, n_tp: int) -> Mesh:
    devices = np.array(jax.devices()[: n_dp * n_tp]).reshape(n_dp, n_tp)
    return Mesh(devices, ("dp", "tp"))


def _tp_layers(graph, n_tp: int) -> set:
    """Graph indices of convs whose filters shard evenly over `n_tp`."""
    out = set()
    for i, l in enumerate(graph.layers):
        if (l.kind == "convolutional" and getattr(l, "groups", 1) == 1
                and getattr(l, "share_index", None) is None
                and l.n % n_tp == 0):
            out.add(i)
    return out


def _leaf_spec(key, arr, n, axis):
    """PartitionSpec for one param/opt leaf of an eligible conv."""
    shape = getattr(arr, "shape", ())
    if key in ("w", "w_q") and len(shape) == 4 and shape[3] == n:
        return P(None, None, None, axis)
    if len(shape) == 1 and shape[0] == n:   # b / scales / rolling_* / w_scale
        return P(axis)
    return P()


def tp_param_specs(graph, params, n_tp: int, *, axis: str = "tp") -> list:
    """PartitionSpec pytree matching a params list (list of dicts)."""
    elig = _tp_layers(graph, n_tp)
    specs = []
    for i, p in enumerate(params):
        n = graph.layers[i].n if i in elig else -1
        specs.append({k: _leaf_spec(k, v, n, axis) if i in elig else P()
                      for k, v in p.items()})
    return specs


def tp_opt_specs(graph, opt_state, params, n_tp: int,
                 *, axis: str = "tp") -> dict:
    """Specs for an SGD/Adam state dict: the params-shaped slot lists
    ("u"/"m"/"v") shard exactly like the params; scalars replicate."""
    elig = _tp_layers(graph, n_tp)

    def slots(tree):
        out = []
        for i, p in enumerate(tree):
            n = graph.layers[i].n if i in elig else -1
            out.append({k: _leaf_spec(k, v, n, axis) if i in elig else P()
                        for k, v in p.items()})
        return out

    return {k: slots(v) if isinstance(v, list) else P()
            for k, v in opt_state.items()}


def _named(mesh, specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def shard_tp_params(mesh, graph, params, *, axis: str = "tp"):
    specs = tp_param_specs(graph, params, mesh.shape[axis], axis=axis)
    return jax.device_put(params, _named(mesh, specs))


def make_tp_forward(graph, mesh, *, axis: str = "tp",
                    dp_axis: str | None = "dp", compute_dtype=None,
                    fused_bn: bool = True, decode: bool = True):
    """Jitted inference fn with conv filters sharded over `axis` (and the
    batch over `dp_axis` when the mesh has it).  Same output contract as
    parallel.spatial.make_spatial_forward."""
    import jax.numpy as jnp

    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.ops import yolo as yoloops

    fwd = make_forward(graph, compute_dtype=compute_dtype,
                       fused_bn=fused_bn)
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
    dp = dp_axis if (dp_axis and dp_axis in mesh.shape) else None
    x_sh = NamedSharding(mesh, P(dp, None, None, None))
    cache = {}

    def wrap(params, x):
        if "f" not in cache:
            specs = tp_param_specs(graph, params, mesh.shape[axis],
                                   axis=axis)
            cache["f"] = jax.jit(run,
                                 in_shardings=(_named(mesh, specs), x_sh),
                                 out_shardings=rep)
        return cache["f"](params, x)

    return wrap


def make_tp_train_step(graph, mesh, *, axis: str = "tp",
                       dp_axis: str | None = "dp",
                       sp_axis: str | None = None,
                       accum: int = 1, compute_dtype=None):
    """One jitted training step with filters+grads+opt slots sharded over
    `axis`, the batch over `dp_axis`, and optionally the image height
    over `sp_axis` (3D dp x sp x tp composition).  The emitted step is
    the stock make_train_step body — GSPMD derives the sharded program
    (filter-slice matmuls, activation all-gathers, dp psum) from the
    in/out shardings alone.  Call as ``step(params, opt, x, truths, rng,
    lr)`` with params/opt placed via the returned `place` helper."""
    from darknet_tpu.train.step import make_train_step

    inner = make_train_step(graph, jit=False, accum=accum,
                            compute_dtype=compute_dtype)
    rep = NamedSharding(mesh, P())
    dp = dp_axis if (dp_axis and dp_axis in mesh.shape) else None
    sp = sp_axis if (sp_axis and sp_axis in mesh.shape) else None
    x_sh = NamedSharding(mesh, P(dp, sp, None, None))
    t_sh = NamedSharding(mesh, P(dp))
    n_tp = mesh.shape[axis]

    cache = {}

    def step(params, opt_state, x, truths, rng, lr):
        if "f" not in cache:
            pspec = _named(mesh, tp_param_specs(graph, params, n_tp,
                                                axis=axis))
            ospec = _named(mesh, tp_opt_specs(graph, opt_state, params,
                                              n_tp, axis=axis))
            cache["pspec"], cache["ospec"] = pspec, ospec
            cache["f"] = jax.jit(
                inner,
                in_shardings=(pspec, ospec, x_sh, t_sh, rep, rep),
                out_shardings=(pspec, ospec, rep, rep))
        return cache["f"](params, opt_state, x, truths, rng, lr)

    def place(params, opt_state, x=None, truths=None):
        pspec = _named(mesh, tp_param_specs(graph, params, n_tp, axis=axis))
        ospec = _named(mesh, tp_opt_specs(graph, opt_state, params, n_tp,
                                          axis=axis))
        out = [jax.device_put(params, pspec),
               jax.device_put(opt_state, ospec)]
        if x is not None:
            out.append(jax.device_put(np.asarray(x), x_sh))
        if truths is not None:
            out.append(jax.device_put(np.asarray(truths), t_sh))
        return tuple(out)

    return step, place
