"""The jitted training step: forward + YOLO deltas + vjp + optimizer.

Reference flow (TrainNetworkDatum, network.cpp:188-215): forward fills each
YOLO layer's `delta` (gradient-ascent direction w.r.t. its activated
output), backward pulls those deltas through the graph into
`weight_updates`, then UpdateNetwork applies SGD/Adam.  Here the whole thing
is ONE XLA program: `jax.vjp` of the forward (to the raw head outputs) with
the hand-computed deltas as cotangents — keeping the reference's exact
training math (including its deliberate deviations from true autodiff, e.g.
no sigmoid-derivative on x/y/obj/cls, decoupled IoU gradients) while XLA
autodiffs every other layer.

Loss-scale semantics (network_kernels.cu / convolutional_kernels.cu):
cotangents are multiplied by `loss_scale` and gradients divided by it again
before the update.

BN rolling statistics update 0.9/0.1 per step (batchnorm_layer.cpp:221-224)
outside the gradient path.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from darknet_tpu.nn.emit import make_forward
from darknet_tpu.train import optimizer as opt
from darknet_tpu.train.yolo_loss import yolo_head_delta


def head_delta(raw, truths, l, net, rng, hi):
    """Delta (gradient-ascent cotangent of the RAW head output), scalar
    cost and metrics dict for ONE trainable head.  `hi` is the head's
    GLOBAL index over the whole graph (the detection head folds it into
    its rng stream), so pipeline stages computing a subset of heads draw
    the same randomness as the unsliced step."""
    if l.kind == "gaussian_yolo":
        from darknet_tpu.train.gaussian_yolo_loss import \
            gaussian_yolo_head_delta

        return gaussian_yolo_head_delta(
            raw.astype(jnp.float32), truths, l, net.w, net.h)
    if l.kind == "yolo":
        return yolo_head_delta(raw.astype(jnp.float32), truths, l,
                               net.w, net.h)
    if l.kind == "detection":
        from darknet_tpu.ops.detection_v1 import (detection_head_delta,
                                                  encode_v1_truth_batch)

        grid = encode_v1_truth_batch(truths, l)
        flat = raw.reshape(raw.shape[0], -1).astype(jnp.float32)
        d, c, m = detection_head_delta(
            flat, grid, l,
            rng_best=jax.random.fold_in(rng, 7 + hi)
            if rng is not None else None)
        d = d.reshape(raw.shape)
        m = dict(m, class_loss=jnp.float32(0), iou_loss=jnp.float32(0))
        return d, c, m
    # cost layer: truths IS the flat target (B, inputs)
    from darknet_tpu.ops.detection_v1 import cost_layer

    flat = raw.reshape(raw.shape[0], -1).astype(jnp.float32)
    tgt = truths.reshape(truths.shape[0], -1).astype(jnp.float32)
    c, d = cost_layer(flat, tgt, l.cost_type, l.ratio)
    d = (d * l.cost_scale).reshape(raw.shape)
    zero = jnp.float32(0)
    m = {"loss": c / flat.shape[0], "avg_iou": zero,
         "count": zero, "class_loss": zero, "iou_loss": zero}
    return d, c, m


# per-GT-averaged head metrics: means over matched GT boxes, so
# micro-batch aggregation must re-weight by each micro's match count for
# the aggregate to equal the single-batch ratio-of-sums
COUNT_WEIGHTED_METRICS = frozenset(
    {"avg_iou", "avg_obj", "avg_cat", "recall50", "recall75"})


def aggregate_micro_metrics(m_stk):
    """Combine one head's per-micro metrics (dict of stacked (M,) leaves)
    into a single dict with make_train_step(accum=M) semantics.  Shared by
    the accum scan here and parallel/pipeline.PipelineTrain so the two
    paths can never diverge in metric semantics."""
    cnt = m_stk.get("count")
    m = {}
    for k, v in m_stk.items():
        if k == "count":
            m[k] = jnp.sum(v)
        elif k in COUNT_WEIGHTED_METRICS and cnt is not None:
            m[k] = jnp.sum(v * cnt) / jnp.maximum(jnp.sum(cnt), 1.0)
        else:
            m[k] = jnp.mean(v)
    return m


def make_micro_grads(graph, *, compute_dtype=None, remat: bool = False,
                     train_act_dtype=None):
    """Build `grads(params, x, truths, rng) -> (grads, cost, metrics_list,
    bn_stats)` for ONE micro-batch: forward, hand-computed head deltas as
    cotangents, vjp.  This is the gradient make_train_step accumulates;
    exposed so a caller can compare it across devices."""
    net = graph.net
    fwd = make_forward(graph, train=True, compute_dtype=compute_dtype,
                       remat=remat, train_act_dtype=train_act_dtype)
    # every trainable head kind, in layer order (= raw_heads order):
    # yolo/gaussian_yolo (v3/v4), detection (v1), cost (classifier era)
    heads = [l for l in graph.layers
             if l.kind in ("yolo", "gaussian_yolo", "detection", "cost")]
    loss_scale = net.loss_scale

    def grads_one_batch(params, x, truths, rng):
        def to_heads(p):
            r = fwd(p, x, rng)
            return r["raw_heads"], r["bn_stats"]

        raw_heads, vjp_fn, bn_stats = jax.vjp(to_heads, params, has_aux=True)

        deltas, costs, metrics_list = [], [], []
        for hi, (raw, l) in enumerate(zip(raw_heads, heads)):
            with jax.named_scope(f"head_delta_{hi}"):
                d, c, m = head_delta(raw, truths, l, net, rng, hi)
            deltas.append(d.astype(raw.dtype) * loss_scale)
            costs.append(c)
            metrics_list.append(m)

        (grads,) = vjp_fn(deltas)
        if loss_scale != 1.0:
            grads = jax.tree_util.tree_map(lambda g: g / loss_scale, grads)
        return grads, jnp.sum(jnp.stack(costs)), metrics_list, bn_stats

    grads_one_batch.n_heads = len(heads)
    return grads_one_batch


def make_train_step(graph, *, compute_dtype=None, use_adam: bool | None = None,
                    donate: bool = True, jit: bool = True,
                    remat: bool = False, accum: int = 1,
                    train_act_dtype=None):
    """Build `train_step(params, opt_state, x, truths, rng, lr)`.

    x: (B, H, W, C) input batch; truths: (B, max_boxes, 5).
    Returns (params, opt_state, cost, metrics).

    train_act_dtype (e.g. jnp.bfloat16) carries the interlayer
    activations (the vjp residuals) at reduced precision — BN statistics
    and the head-feeding layers stay f32.  Default None = f32.

    remat=True checkpoints the conv blocks: the backward pass recomputes
    conv+BN+act instead of storing their intermediates.

    accum > 1 replays the reference's subdivision loop
    (TrainNetwork, network.cpp:210-230: `subdiv` micro-batches of
    `net.batch` images each, gradients accumulated into weight_updates,
    ONE optimizer update at the end).  The micro-batches run under
    lax.scan, so only one micro-batch's activations are live at a time —
    this is what bounds training memory at 608² exactly like the
    reference's batch/subdivisions split does.  B must be divisible by
    accum.  BN batch statistics are per-micro-batch with sequential
    rolling updates, matching the per-datum forward.
    """
    net = graph.net
    if use_adam is None:
        use_adam = net.adam
    grads_one_batch = make_micro_grads(
        graph, compute_dtype=compute_dtype, remat=remat,
        train_act_dtype=train_act_dtype)
    n_heads = grads_one_batch.n_heads

    def step(params, opt_state, x, truths, rng, lr):
        if accum > 1:
            b = x.shape[0]
            assert b % accum == 0, (b, accum)
            # interleaved (strided) micro-batch assignment: under a dp-
            # sharded batch dim, contiguous slices would put each scan
            # step's data on a single device subset; reshape+swap gives
            # every micro-batch an equal LOCAL slice of every dp shard.
            # (Which images share a micro-batch is arbitrary — the loader
            # order is random — it only recomposes the per-micro BN stats.)
            xm = x.reshape(b // accum, accum, *x.shape[1:]).swapaxes(0, 1)
            tm = truths.reshape(b // accum, accum,
                                *truths.shape[1:]).swapaxes(0, 1)
            rngs = (jax.random.split(rng, accum) if rng is not None
                    else jnp.zeros((accum, 2), jnp.uint32))

            def body(acc, inp):
                xb, tb, r = inp
                g, c, mets, stats = grads_one_batch(
                    params, xb, tb, r if rng is not None else None)
                acc = jax.tree_util.tree_map(jnp.add, acc, g)
                return acc, (c, mets, dict(stats))

            zeros = jax.tree_util.tree_map(
                lambda p: jnp.zeros(jnp.shape(p), jnp.result_type(p)
                                    if jnp.issubdtype(jnp.result_type(p),
                                                      jnp.floating)
                                    else jnp.float32), params)
            grads, (costs_m, mets_m, stats_m) = jax.lax.scan(
                body, zeros, (xm, tm, rngs))
            cost = jnp.sum(costs_m)
            # list of dicts, leaves stacked (accum,)
            metrics_list = [aggregate_micro_metrics(m_stk)
                            for m_stk in mets_m]
            # BN rolling: sequential 0.9/0.1 per micro-batch =
            # 0.9^n * old + 0.1 * sum_j 0.9^(n-1-j) * stats_j
            wgt = 0.1 * (0.9 ** jnp.arange(accum - 1, -1, -1,
                                           dtype=jnp.float32))
            bn_stats = {
                i: (0.9 ** accum, (jnp.tensordot(wgt, mv[0], axes=1),
                                   jnp.tensordot(wgt, mv[1], axes=1)))
                for i, mv in stats_m.items()}
        else:
            grads, cost, metrics_list, stats = grads_one_batch(
                params, x, truths, rng)
            bn_stats = {i: (0.9, (0.1 * mv[0], 0.1 * mv[1]))
                        for i, mv in stats.items()}

        # named so trace_report can attribute optimizer time (it would
        # otherwise land in "(other)")
        with jax.named_scope("optimizer_update"):
            if use_adam:
                params, opt_state = opt.adam_update(
                    graph, params, grads, opt_state, lr=lr, B1=net.B1,
                    B2=net.B2, eps=net.eps, decay=net.decay,
                    batch=net.optimizer_batch)
            else:
                params, opt_state = opt.sgd_update(
                    graph, params, grads, opt_state, lr=lr,
                    momentum=net.momentum, decay=net.decay,
                    batch=net.optimizer_batch)

        # rolling BN statistics (0.9/0.1 per micro-batch forward,
        # batchnorm_layer.cpp:221-224) — pre-folded into (keep, contrib)
        new_params = []
        for i, p in enumerate(params):
            if i in bn_stats and "mean" in p:
                keep, (mc, vc) = bn_stats[i]
                p = dict(p)
                p["mean"] = keep * p["mean"] + mc
                p["var"] = keep * p["var"] + vc
            new_params.append(p)
        params = new_params

        metrics = {
            "loss": sum(m["loss"] for m in metrics_list),
            "avg_iou": sum(m["avg_iou"] for m in metrics_list) / n_heads,
            "count": sum(m["count"] for m in metrics_list),
            "class_loss": sum(m["class_loss"] for m in metrics_list),
            "iou_loss_mag": sum(m["iou_loss"] for m in metrics_list),
        }
        return params, opt_state, cost, metrics

    if not jit:
        return step
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(step, donate_argnums=donate_argnums)


def init_opt_state(graph, params, use_adam: bool | None = None,
                   *, iter0: int = 0):
    """iter0 = current iteration when resuming from weights (seen /
    optimizer_batch): the update-gate thresholds (dont_update /
    burnin_update) compare against it exactly like GetCurrIter
    (network.cpp:225-231) — without it, gates would re-freeze from
    iteration 0 on every weights-only restart."""
    if use_adam is None:
        use_adam = graph.net.adam
    return opt.init_adam_state(params, iter0=iter0, graph=graph) \
        if use_adam else opt.init_sgd_state(params, iter0=iter0)
