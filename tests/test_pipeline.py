"""Pipeline (stage-axis) parallelism: stage-partitioned inference must
match the single-device forward exactly — stages reuse the stock emitter
in slice mode, so this gates the cut planning + cross-stage dataflow."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.nn.emit import make_forward
from darknet_tpu.parallel.pipeline import (PipelineForward, crossing_set,
                                           plan_cuts)


def test_crossing_set_tracks_route_backrefs():
    g = build_graph(model_zoo.yolov4_cfg(96, 96))
    # the yolov4 neck routes back into the backbone (layers 54/85); a cut
    # in the neck must carry those backbone outputs forward
    cs = crossing_set(g, 100)
    assert 54 in cs and 85 in cs
    # nothing in the set is at/after the cut and nothing is the cur layer
    assert all(j < 99 for j in cs)


def test_plan_cuts_balanced_and_monotonic():
    g = build_graph(model_zoo.yolov4_cfg(96, 96))
    cuts = plan_cuts(g, 4)
    assert len(cuts) == 3 and cuts == sorted(cuts)
    bf = [l.bflops or 0 for l in g.layers]
    bounds = [0] + cuts + [len(g.layers)]
    shares = [sum(bf[a:b]) for a, b in zip(bounds, bounds[1:])]
    assert max(shares) < 2.2 * (sum(bf) / 4)    # roughly balanced


def test_plan_cuts_never_lands_on_forbidden():
    g = build_graph(model_zoo.yolov4_cfg(96, 96))
    n = len(g.layers)
    # adversarial forbidden set: huge contiguous spans around every
    # BFLOP-balanced target, so both the monotonic bump and the backward
    # snap paths get exercised
    forbidden = set(range(2, n // 2)) | set(range(n // 2 + 1, n - 2))
    cuts = plan_cuts(g, 4, forbidden=forbidden)
    assert cuts == sorted(set(cuts)), cuts              # strictly monotone
    assert not set(cuts) & forbidden, (cuts,)           # all legal
    # fully-forbidden interior -> explicit error, not a silent bad cut
    with pytest.raises(ValueError):
        plan_cuts(g, 4, forbidden=set(range(1, n)))


def test_pipeline_tiny_matches_single_device(rng):
    g = build_graph(model_zoo.yolov4_tiny_cfg(128, 128))
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=0))
    x = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)

    ref = make_forward(g, fused_bn=True)(params, jnp.asarray(x))["heads"]

    pf = PipelineForward(g, params, jax.devices()[:4], microbatches=2)
    heads = pf(x)
    assert len(heads) == len(ref)
    for a, b in zip(heads, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_train_matches_accum_step(rng):
    """PipelineTrain (4 stages, 2 micro-batches) must reproduce
    make_train_step(accum=2): same summed-grad optimizer apply, same
    sequential BN rolling updates, same cost/metrics."""
    from darknet_tpu.parallel.pipeline import PipelineTrain
    from darknet_tpu.train.step import init_opt_state, make_train_step

    g = build_graph(model_zoo.yolov4_tiny_cfg(128, 128, batch=4, subdiv=2),
                    train=True)
    params = paramlib.init_params(g, seed=0)
    x = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    truths = np.zeros((4, 6, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    truths[:, 1] = [0.25, 0.7, 0.2, 0.4, 2]
    key = jax.random.PRNGKey(9)

    step = make_train_step(g, accum=2, donate=False)
    ref_p, ref_opt = params, init_opt_state(g, params)
    for it in range(2):
        ref_p, ref_opt, ref_cost, ref_m = step(
            ref_p, ref_opt, jnp.asarray(x), jnp.asarray(truths),
            jax.random.fold_in(key, it), jnp.float32(1e-3))

    pt = PipelineTrain(g, params, jax.devices()[:4], microbatches=2)
    for it in range(2):
        cost, m = pt.step(x, truths, jax.random.fold_in(key, it), 1e-3)

    np.testing.assert_allclose(float(cost), float(ref_cost),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(m["count"]), float(ref_m["count"]))
    got = pt.gather_params()
    for i, (a, b) in enumerate(zip(got, ref_p)):
        for k in b:
            # atol 5e-5 (was 2e-5): the fused BN+act train epilogue's
            # hand-written VJP (ops/train_epilogue.py) recomputes the
            # activation gradient from y_hat, which rounds differently
            # under the pipeline's stage slicing than under accum's
            # whole-graph fusion — bisected to that commit, 4/36864
            # weights at abs 3.6e-5 after 2 iters.  The epilogue's own
            # gradient parity is gated in test_train_epilogue; this
            # gate is about pipeline plumbing (a missing cross-stage
            # cotangent shows as O(1) error, far above this band).
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), rtol=2e-4, atol=5e-5,
                err_msg=f"layer {i} param {k}")


def test_pipeline_train_yolov4_backref_cotangents(rng):
    """Full yolov4 train step over 4 stages: the neck's long route
    back-references carry backbone tensors through intermediate stages as
    identities — their loss cotangents must flow back through each
    stage's vjp to the producing stage.

    Gate: cost matches tightly; param-update DIRECTION and MAGNITUDE
    match per layer.  (Elementwise tolerance is unachievable here: the
    full yolov4 at random init amplifies ulp-level forward differences
    into ~5% relative gradient noise — measured: a 3e-7 input
    perturbation shifts single-device grads 4-6%.  A missing or
    double-counted cross-stage cotangent path shows as an O(1) norm or
    cosine error, far above that floor.)"""
    from darknet_tpu.parallel.pipeline import PipelineTrain
    from darknet_tpu.train.step import init_opt_state, make_train_step

    g = build_graph(model_zoo.yolov4_cfg(96, 96, batch=2, subdiv=1),
                    train=True)
    params = paramlib.init_params(g, seed=3)
    x = rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    truths = np.zeros((2, 4, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.4, 0.4, 0]
    key = jax.random.PRNGKey(11)

    step = make_train_step(g, donate=False)
    ref_p, _, ref_cost, _ = step(
        params, init_opt_state(g, params), jnp.asarray(x),
        jnp.asarray(truths), key, jnp.float32(1e-3))

    pt = PipelineTrain(g, params, jax.devices()[:4], microbatches=1)
    cost, _ = pt.step(x, truths, key, 1e-3)

    np.testing.assert_allclose(float(cost), float(ref_cost),
                               rtol=1e-4, atol=1e-5)
    got = pt.gather_params()
    # early conv (stage 0), backbone convs the neck routes to (54/85 —
    # their grads sum local + cross-stage cotangent paths), late conv
    for i in [0, 54, 85, len(g.layers) - 2]:
        for k in ref_p[i]:
            da = np.asarray(got[i][k], np.float64) - \
                np.asarray(params[i][k], np.float64)
            db = np.asarray(ref_p[i][k], np.float64) - \
                np.asarray(params[i][k], np.float64)
            na, nb = np.linalg.norm(da), np.linalg.norm(db)
            assert nb > 0, (i, k)
            cos = float(np.dot(da.ravel(), db.ravel()) / (na * nb))
            ratio = float(na / nb)
            assert cos > 0.98, (i, k, cos)
            assert 0.85 < ratio < 1.15, (i, k, ratio)


def test_train_slice_mode_dropout_rng_offset(rng):
    """A train-mode slice must draw the SAME dropout masks as the
    corresponding span of the unsliced program (drop rng indices are
    global, offset by the number of consumers below _lo)."""
    cfg = model_zoo._net(64, 64, 2, 1)
    cfg += model_zoo._conv(16, 3, 1, act="leaky")          # 0
    cfg += "[dropout]\nprobability=.3\n\n"                 # 1
    cfg += model_zoo._conv(16, 3, 1, act="leaky")          # 2
    cfg += "[dropout]\nprobability=.4\n\n"                 # 3
    cfg += model_zoo._conv(33, 1, 1, act="linear")         # 4
    cfg += ("[yolo]\nmask=0,1,2\nnum=3\nclasses=6\n"
            "anchors=10,10, 20,20, 30,30\n\n")             # 5
    g = build_graph(cfg, train=True)
    params = paramlib.init_params(g, seed=2)
    fwd = make_forward(g, train=True)
    x = jnp.asarray(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    key = jax.random.PRNGKey(3)

    full = fwd(params, x, key)

    mid = fwd(params, x, key, _lo=0, _hi=3)
    extern = {k: mid["outs"][k] for k in mid["outs"]}
    part = fwd(params, mid["output"], key, _lo=3, _extern=extern)
    np.testing.assert_allclose(np.asarray(part["heads"][0]),
                               np.asarray(full["heads"][0]),
                               rtol=1e-6, atol=1e-6)


def test_pipeline_yolov4_neck_backrefs(rng):
    """Full yolov4 at 96²: cuts land in the neck, forcing multi-stage
    carry of backbone outputs (the hard dataflow case)."""
    g = build_graph(model_zoo.yolov4_cfg(96, 96))
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=1))
    x = rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)

    ref = make_forward(g, fused_bn=True)(params, jnp.asarray(x))["heads"]

    pf = PipelineForward(g, params, jax.devices()[:4], microbatches=1)
    heads = pf(x)
    for a, b in zip(heads, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
