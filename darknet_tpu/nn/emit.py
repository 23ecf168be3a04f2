"""Graph IR -> executable JAX forward function.

Where the reference interprets the layer array per step
(`network.cpp:101-127` ForwardNetwork), we close over the IR and emit one
Python function whose single trace becomes one XLA program: static shapes,
no per-layer dispatch at runtime, full cross-layer fusion.

The emitted function keeps only the intermediate outputs that later layers
reference (liveness analysis over route/shortcut/scale_channels edges); XLA
frees the rest during execution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from darknet_tpu.ops import shapes as shapeops
from darknet_tpu.ops import yolo as yoloops
from darknet_tpu.ops.activations import apply_activation
from darknet_tpu.ops.conv import (batchnorm_block, connected_block, conv_block)
from darknet_tpu.ops.pooling import global_avgpool, maxpool_block


def _liveness(graph) -> set:
    """Indices whose outputs are consumed by a non-adjacent later layer."""
    live = set()
    for i, l in enumerate(graph.layers):
        for s in l.input_indices():
            live.add(s)
    # head outputs are returned
    for l in graph.layers:
        if l.kind in ("yolo", "gaussian_yolo", "detection", "cost"):
            live.add(l.index)
    if graph.layers:
        live.add(len(graph.layers) - 1)
    return live


def local_block(x, p, l):
    """[local] locally-connected layer (local_layer.c): per-position conv
    weights.  Patches via XLA's patch extractor, then a per-location
    contraction."""
    from jax import lax

    patches = lax.conv_general_dilated_patches(
        x, filter_shape=(l.size, l.size),
        window_strides=(l.stride, l.stride),
        padding=[(l.pad, l.pad), (l.pad, l.pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )  # (B, OH, OW, C*size*size) with channel-major patch layout
    b = x.shape[0]
    loc = l.out_h * l.out_w
    patches = patches.reshape(b, loc, -1)
    # w: (locations, n, size*size*c) — darknet's im2col layout is
    # (c*size*size) with channel-major too (c, kh, kw)
    y = jnp.einsum("blk,lnk->bln", patches, jnp.asarray(p["w"]),
                   preferred_element_type=jnp.float32)
    # darknet local biases are per output element, CHW (n, oh*ow) order
    y = y + jnp.asarray(p["b"]).reshape(l.n, loc).T[None]
    y = apply_activation(y, l.activation)
    return y.reshape(b, l.out_h, l.out_w, l.n)



def _aa_backref_needed(l, i, live) -> bool:
    """True when layer i is a stride>1 antialiased layer that some later
    layer back-references — the case where the reference exposes its
    front-filled stride-1 buffer (ops/conv.antialias_backref_view)."""
    return (bool(getattr(l, "antialiasing", 0)) and i in live
            and (l.blur_stride_x > 1 or l.blur_stride_y > 1))


def _aa_split(y, l):
    """(blurred sequential tensor, stride-1 front-filled backref view)."""
    from darknet_tpu.ops.conv import antialias_backref_view, antialias_blur

    blur = antialias_blur(y, l)
    return blur, antialias_backref_view(y, blur, l)


def make_forward(graph, *, train: bool = False, compute_dtype=None,
                 fused_bn: bool = False, remat: bool = False,
                 probe_conv_absmax: bool = False,
                 train_act_dtype=None):
    """Build `forward(params, x, rng=None) -> dict`.

    Returns a dict with:
      "heads":  list of activated head outputs (NHWC, darknet channel order)
      "output": final layer's output tensor
      "bn_stats": {layer_index: (mean, var)} when train
      "raw_heads": raw (pre-activation) head conv outputs when train
      "conv_in_absmax": {layer_index: scalar max|input|} when
        probe_conv_absmax — the int8 calibration probe
    """
    live = _liveness(graph)
    layers = graph.layers
    # layers whose output a head consumes directly (heads read the
    # previous layer): kept f32 under train_act_dtype so head/loss math
    # is dtype-identical to the default path
    head_feed = {j - 1 for j, l in enumerate(layers)
                 if l.kind in ("yolo", "gaussian_yolo", "detection", "cost")}
    # layers that consume per-step randomness during training: dropout
    # masks and the [crop] layer's random offset/flip (crop_layer.c:64-67)
    n_dropout = sum(1 for l in layers
                    if l.kind in ("dropout", "crop")) if train else 0

    def forward(params, x, rng=None, *, _lo=0, _hi=None, _extern=None):
        """_lo/_hi/_extern: pipeline-stage slicing (parallel/pipeline.py) —
        emit only layers [_lo, _hi), with `x` as layer _lo's input and
        `_extern` seeding the cross-stage live outputs.  The dropout/crop
        rng split is counted over the WHOLE net (drop_i starts at the
        number of consumers below _lo), so a stage draws the same masks
        as the corresponding span of the unsliced program."""
        outs: dict[int, jnp.ndarray] = dict(_extern or {})
        backref_views: dict[int, jnp.ndarray] = {}
        bn_stats: dict[int, tuple] = {}
        conv_absmax: dict[int, jnp.ndarray] = {}
        heads: list = []
        raw_heads: list = []
        cur = x
        if train and rng is not None and n_dropout:
            drop_rngs = list(jax.random.split(rng, n_dropout))
        else:
            drop_rngs = []
        drop_i = sum(1 for l in layers[:_lo]
                     if l.kind in ("dropout", "crop")) if _lo else 0

        for i, l in enumerate(layers):
            if _hi is not None and i >= _hi:
                break
            if i < _lo:
                continue
            # named_scope: per-layer HLO metadata so profiler
            # traces (utils/profiler.trace_report) can attribute
            # fused-op time back to cfg layers
            with jax.named_scope(f"L{i:03d}_{l.kind}"):
                k = l.kind
                if k == "convolutional":
                    if probe_conv_absmax:
                        conv_absmax[i] = jnp.max(jnp.abs(
                            cur.astype(jnp.float32)))
                    src = l.share_index if l.share_index is not None else i
                    p = params[src]
                    import dataclasses as _dc
                    if fused_bn:
                        # BN already folded into w/b
                        l_eff = _dc.replace(l, batch_normalize=False) \
                            if l.batch_normalize else l
                    else:
                        l_eff = l
                    # back-referenced stride>1 antialiased conv: compute
                    # the conv and blur separately so outs[i] can carry
                    # the reference's front-filled (h, w, c) buffer view
                    # (ops/conv.antialias_backref_view) while sequential
                    # flow gets the blurred tensor
                    aa_backref = _aa_backref_needed(l, i, live)
                    if aa_backref:
                        l_eff = _dc.replace(l_eff, antialiasing=0)
                    # y_hat residual dtype for the fused BN+act epilogue:
                    # reduced precision everywhere the interlayer act16
                    # cast already applies (head-feeding convs stay f32)
                    res_dt = train_act_dtype if i not in head_feed else None
                    if train and remat:
                        # trade FLOPs for HBM: recompute the conv block in the
                        # backward pass instead of storing its intermediates
                        block = jax.checkpoint(
                            lambda x, p, l_eff=l_eff: conv_block(
                                x, p, l_eff, train=True,
                                compute_dtype=compute_dtype,
                                res_dtype=res_dt))
                        cur, st = block(cur, p)
                    elif not train and "w_q" in p:
                        from darknet_tpu.ops.conv import conv_block_int8

                        cur = conv_block_int8(
                            cur, p, l_eff,
                            compute_dtype=compute_dtype or jnp.float32)
                        st = None
                    else:
                        cur, st = conv_block(cur, p, l_eff, train=train,
                                             compute_dtype=compute_dtype,
                                             res_dtype=res_dt)
                    if st is not None:
                        bn_stats[i] = st
                    if aa_backref:
                        cur, backref_views[i] = _aa_split(cur, l)
                    if (train and train_act_dtype is not None
                            and i not in head_feed):
                        # reduced-precision interlayer tensor (vjp
                        # residual); head-feeding convs stay f32 so the
                        # loss math is dtype-identical to the default
                        cur = cur.astype(train_act_dtype)
                elif k == "connected":
                    cur, st = connected_block(cur, params[i], l, train=train,
                                              compute_dtype=compute_dtype)
                    cur = cur.reshape(cur.shape[0], 1, 1, -1)
                    if st is not None:
                        bn_stats[i] = st
                elif k == "batchnorm":
                    cur, st = batchnorm_block(cur, params[i], l, train=train)
                    if st is not None:
                        bn_stats[i] = st
                elif k == "local":
                    cur = local_block(cur, params[i], l)
                elif k == "maxpool":
                    # back-referenced antialiased maxpool: same front-filled
                    # stride-1 buffer view as the conv case — its forward
                    # also memcpy's only the blur output over the front
                    # (maxpool_layer.cpp:86-95); found live by fuzz seed 653
                    # (scale_channels from an antialiased maxpool)
                    if _aa_backref_needed(l, i, live):
                        from darknet_tpu.ops.pooling import maxpool

                        cur, backref_views[i] = _aa_split(
                            maxpool(cur, l, train=train), l)
                    else:
                        cur = maxpool_block(cur, l, train=train)
                elif k == "avgpool":
                    cur = global_avgpool(cur)
                elif k == "route":
                    cur = shapeops.route([outs[s] for s in l.layers],
                                         l.groups, l.group_id)
                elif k == "shortcut":
                    cur = shapeops.shortcut(cur, outs[l.from_layer], l.activation)
                elif k == "scale_channels":
                    cur = shapeops.scale_channels(
                        cur, outs[l.from_layer], l.scale_wh, l.activation)
                elif k == "upsample":
                    if l.reverse:
                        cur = shapeops.upsample_reverse(cur, l.stride, l.scale)
                    else:
                        cur = shapeops.upsample(cur, l.stride, l.scale)
                elif k == "reorg":
                    cur = shapeops.reorg3d(cur, l.stride, l.reverse,
                                           (l.out_h, l.out_w, l.out_c))
                elif k == "reorg_old":
                    cur = shapeops.reorg_old(cur, l.stride, l.reverse,
                                             (l.out_h, l.out_w, l.out_c))
                elif k == "dropout":
                    if train and drop_rngs:
                        if l.dropblock:
                            cur = shapeops.dropblock(
                                cur, drop_rngs[drop_i], l.probability,
                                l.dropblock_size_abs, l.dropblock_size_rel)
                        else:
                            cur = shapeops.dropout(
                                cur, drop_rngs[drop_i], l.probability)
                        drop_i += 1
                    # inference: identity (dropout_layer.c:89-93)
                elif k == "crop":
                    crop_rng = None
                    if train and drop_rngs:
                        crop_rng = drop_rngs[drop_i]
                        drop_i += 1
                    cur = shapeops.crop_layer(cur, l, train=train,
                                              rng=crop_rng)
                elif k == "activation":
                    cur = apply_activation(cur, l.activation)
                elif k == "yolo":
                    if train:
                        raw_heads.append(cur)
                    cur = yoloops.yolo_activate(cur, l)
                    heads.append(cur)
                elif k == "gaussian_yolo":
                    if train:
                        raw_heads.append(cur)
                    cur = yoloops.gaussian_yolo_activate(cur, l)
                    heads.append(cur)
                elif k == "detection":
                    # YOLOv1 head: forward is identity at inference
                    cur = cur.reshape(cur.shape[0], 1, 1, -1)
                    if train:
                        raw_heads.append(cur)
                    heads.append(cur)
                elif k == "cost":
                    # identity forward; during training the loss delta applies
                    # to the layer input (cost_layer.c:64-87 backward axpy)
                    if train:
                        raw_heads.append(cur)
                elif k in ("empty", "blank"):
                    pass  # identity
                else:
                    raise NotImplementedError(f"layer kind {k}")

                # stopbackward: BackwardNetwork breaks at this layer
                # (network.cpp:179-181) — no gradient reaches it or anything
                # below; onlyforward skips just this layer's backward.  Both
                # lower to a stop_gradient on the layer's output.
                if train and (l.stopbackward or l.onlyforward):
                    cur = jax.lax.stop_gradient(cur)

                if i in live:
                    # antialiased stride>1 convs expose a different
                    # tensor to back-references than to sequential flow
                    outs[i] = backref_views.pop(i, cur)

        result = {"heads": heads, "output": cur}
        if _lo or _hi is not None:
            # pipeline-stage mode: expose the live outputs so the driver
            # can forward the cross-stage set (callers jitting the plain
            # forward must not materialize every live tensor)
            result["outs"] = outs
        if train:
            result["bn_stats"] = bn_stats
            result["raw_heads"] = raw_heads
        if probe_conv_absmax:
            result["conv_in_absmax"] = conv_absmax
        return result

    return forward
