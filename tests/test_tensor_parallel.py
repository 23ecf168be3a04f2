"""Tensor (filter-dim) parallelism: the GSPMD-sharded forward and train
step must match the single-device result — filter-slice convs, activation
all-gathers and dp psums are inserted by XLA from the shardings alone.

The reference has no model-parallel mode at all (SURVEY.md §2.7 — only
whole-network replication via SyncNetworks, network_kernels.cu); this is
an extension, so the gate is internal consistency, not
reference parity.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.parallel.tensor import (make_tp_forward, make_tp_mesh,
                                         make_tp_train_step,
                                         shard_tp_params, tp_param_specs)


def test_tp_specs_shard_only_eligible_convs():
    g = build_graph(model_zoo.yolov4_tiny_cfg(128, 128))
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=0))
    specs = tp_param_specs(g, params, 4)
    n_sharded = 0
    for i, (l, sp) in enumerate(zip(g.layers, specs)):
        for k, s in sp.items():
            if s != P():
                assert l.kind == "convolutional" and l.n % 4 == 0, (i, k)
                n_sharded += 1
    assert n_sharded > 10          # the backbone really is sharded
    # head convs (255 filters) must stay replicated
    for l, sp in zip(g.layers, specs):
        if l.kind == "convolutional" and l.n % 4:
            assert all(s == P() for s in sp.values()), l.index


def test_tp_inference_matches_single_device(rng):
    cfg = model_zoo.yolov4_tiny_cfg(128, 128)
    g = build_graph(cfg)
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=0))
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)

    mesh = make_tp_mesh(2, 4)            # 2-way dp x 4-way tensor
    f = make_tp_forward(g, mesh, fused_bn=True)
    pr = shard_tp_params(mesh, g, params)
    boxes_s, obj_s, cls_s = f(pr, jax.device_put(
        x, jax.sharding.NamedSharding(mesh, P("dp", None, None, None))))

    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.ops import yolo as yoloops

    fwd = make_forward(g, fused_bn=True)
    r = fwd(params, jnp.asarray(x))
    outs = [yoloops.yolo_decode(t, l, 128, 128)
            for t, l in zip(r["heads"], g.heads())]
    boxes = np.concatenate([np.asarray(o[0]) for o in outs], axis=1)
    obj = np.concatenate([np.asarray(o[1]) for o in outs], axis=1)
    cls = np.concatenate([np.asarray(o[2]) for o in outs], axis=1)

    np.testing.assert_allclose(np.asarray(boxes_s), boxes, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(obj_s), obj, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(cls_s), cls, rtol=2e-4, atol=2e-5)


def test_tp_train_step_matches_single_device(rng):
    from darknet_tpu.train.step import init_opt_state, make_train_step

    size, batch = 128, 4
    cfg = model_zoo.yolov4_tiny_cfg(size, size, batch=batch, subdiv=1)
    g = build_graph(cfg, train=True)
    params = paramlib.init_params(g, seed=0)
    opt0 = init_opt_state(g, params)
    x = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    truths = np.zeros((batch, 8, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    rngkey = jax.random.PRNGKey(0)
    lr = jnp.float32(1e-3)

    # single-device reference step
    step1 = make_train_step(g, donate=False)
    p1, o1, cost1, _ = step1(params, opt0, jnp.asarray(x),
                             jnp.asarray(truths), rngkey, lr)

    mesh = make_tp_mesh(2, 4)
    step, place = make_tp_train_step(g, mesh)
    pm, om, xm, tm = place(params, opt0, x, truths)
    p2, o2, cost2, _ = step(pm, om, xm, tm, rngkey, lr)

    np.testing.assert_allclose(float(cost2), float(cost1), rtol=1e-5)
    for i, (a, b) in enumerate(zip(p1, p2)):
        for k in a:
            # atol 2e-4: GSPMD splits the batch reductions (BN stats,
            # bias grads) into per-shard partials + psum — a different
            # f32 summation order — and rounding-level forward diffs can
            # flip a handful of near-tie loss-assignment comparisons
            # (ignore_thresh masks), perturbing isolated grad elements
            np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                       rtol=1e-4, atol=2e-4,
                                       err_msg=f"layer {i} {k}")


def test_tp_composes_with_spatial_3d_mesh(rng):
    """dp x sp x tp in one mesh: the full 3-way composition the dryrun
    exercises (batch + height + filter sharding in a single jit)."""
    from darknet_tpu.train.step import init_opt_state, make_train_step

    size, batch = 128, 4
    cfg = model_zoo.yolov4_tiny_cfg(size, size, batch=batch, subdiv=1)
    g = build_graph(cfg, train=True)
    params = paramlib.init_params(g, seed=0)
    opt0 = init_opt_state(g, params)
    x = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    truths = np.zeros((batch, 8, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    rngkey = jax.random.PRNGKey(0)
    lr = jnp.float32(1e-3)

    step1 = make_train_step(g, donate=False)
    p1, _, cost1, _ = step1(params, opt0, jnp.asarray(x),
                            jnp.asarray(truths), rngkey, lr)

    devices = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh = Mesh(devices, ("dp", "sp", "tp"))
    step, place = make_tp_train_step(g, mesh, sp_axis="sp")
    pm, om, xm, tm = place(params, opt0, x, truths)
    p2, _, cost2, _ = step(pm, om, xm, tm, rngkey, lr)

    np.testing.assert_allclose(float(cost2), float(cost1), rtol=1e-5)
    l_last = max(i for i, l in enumerate(g.layers)
                 if l.kind == "convolutional")
    np.testing.assert_allclose(np.asarray(p2[l_last]["w"]),
                               np.asarray(p1[l_last]["w"]),
                               rtol=1e-4, atol=2e-4)
