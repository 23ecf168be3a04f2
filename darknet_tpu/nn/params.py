"""Parameter PyTree construction: init, BN folding, dtype policy.

Params are a list (one dict per layer) of f32 numpy/jnp arrays:

* convolutional: ``{"w": (kh,kw,c/g,n), "b": (n,)}`` plus
  ``{"scales","mean","var"}: (n,)`` when batch-normalized;
* connected:     ``{"w": (inputs,outputs), "b": (outputs,)}`` (+BN);
* batchnorm:     ``{"b","scales","mean","var"}: (c,)``;
* local:         ``{"w": (locations, n, size*size*c), "b": (outputs,)}``;
* all other layers: ``{}``.

Initialization matches the reference: He-style uniform
``sqrt(2/(k*k*c/g)) * U(-1,1)`` for conv (`convolutional_layer.cpp:478-493`),
``U(-1,1)/sqrt(inputs)`` for connected, BN scales 1 / rolling stats (0, 1).
"""

from __future__ import annotations

import numpy as np



def init_params(graph, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    params: list[dict] = []
    for l in graph.layers:
        p: dict = {}
        if l.kind == "convolutional":
            if l.share_index is not None:
                params.append(p)
                continue
            cg = l.c // l.groups
            scale = np.sqrt(2.0 / (l.size * l.size * cg))
            if l.activation.startswith("normalize_channels"):
                w = np.ones((l.size, l.size, cg, l.n), dtype=np.float32)
            else:
                w = (scale * rng.uniform(-1, 1,
                     (l.size, l.size, cg, l.n))).astype(np.float32)
            p["w"] = w
            p["b"] = np.zeros(l.n, dtype=np.float32)
            if l.batch_normalize:
                p["scales"] = np.ones(l.n, dtype=np.float32)
                p["mean"] = np.zeros(l.n, dtype=np.float32)
                p["var"] = np.ones(l.n, dtype=np.float32)
        elif l.kind == "connected":
            scale = 1.0 / np.sqrt(l.inputs)
            p["w"] = (scale * rng.uniform(
                -1, 1, (l.inputs, l.outputs))).astype(np.float32)
            p["b"] = np.zeros(l.outputs, dtype=np.float32)
            if l.batch_normalize:
                p["scales"] = np.ones(l.outputs, dtype=np.float32)
                p["mean"] = np.zeros(l.outputs, dtype=np.float32)
                p["var"] = np.ones(l.outputs, dtype=np.float32)
        elif l.kind == "batchnorm":
            p["b"] = np.zeros(l.c, dtype=np.float32)
            p["scales"] = np.ones(l.c, dtype=np.float32)
            p["mean"] = np.zeros(l.c, dtype=np.float32)
            p["var"] = np.ones(l.c, dtype=np.float32)
        elif l.kind == "local":
            locations = l.out_w * l.out_h
            scale = 1.0 / np.sqrt(l.size * l.size * l.c)
            p["w"] = (scale * rng.uniform(
                -1, 1, (locations, l.n, l.size * l.size * l.c))
            ).astype(np.float32)
            p["b"] = np.zeros(l.outputs, dtype=np.float32)
        params.append(p)
    return params


def fuse_conv_batchnorm(graph, params: list) -> list:
    """FuseConvBatchNorm (network.cpp:647-682): fold rolling stats into conv
    weights/biases for inference; weight-shared convs drop their BN.
    Returns new params; the caller should treat BN as disabled afterwards
    (emit with `fused=True`)."""
    out = []
    for l, p in zip(graph.layers, params):
        if (l.kind == "convolutional" and l.batch_normalize
                and l.share_index is None and "scales" in p):
            # pure numpy on host: eager per-layer device ops would cost a
            # device round-trip per array
            w = np.asarray(p["w"], dtype=np.float32)
            b = np.asarray(p["b"], dtype=np.float32)
            scales = np.asarray(p["scales"], dtype=np.float32)
            mean = np.asarray(p["mean"], dtype=np.float32)
            var = np.asarray(p["var"], dtype=np.float32)
            std = np.sqrt(var + 1e-5)
            out.append({"w": w * (scales / std)[None, None, None, :],
                        "b": b - scales * mean / std})
        else:
            out.append(dict(p))
    return out


def quantize_conv_params(graph, params: list, *, min_ch: int = 128,
                         skip_heads: bool = True) -> list:
    """Add int8 weights to eligible convs for the quantized inference path
    (ops/conv.conv_block_int8) — the analogue of the reference's
    binarize_weights (convolutional_layer.cpp:42), with per-output-channel
    symmetric absmax scales instead of per-filter means.

    Call AFTER fuse_conv_batchnorm.  Eligible: groups==1, dilation==1, no
    weight sharing, min(c, n) >= min_ch (small layers are overhead-bound),
    and — when skip_heads — not a conv feeding a detection head (kept
    full-precision for accuracy, standard int8 deployment practice).
    """
    head_inputs = set()
    if skip_heads:
        for l in graph.layers:
            if l.kind in ("yolo", "gaussian_yolo", "detection"):
                head_inputs.add(l.index - 1)
    out = []
    for l, p in zip(graph.layers, params):
        p = dict(p)
        if (l.kind == "convolutional" and l.groups == 1 and l.dilation == 1
                and l.share_index is None and "w" in p
                and min(l.c, l.n) >= min_ch
                and l.index not in head_inputs):
            w = np.asarray(p["w"], dtype=np.float32)
            absmax = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0),
                                1e-8)
            scale = (absmax / 127.0).astype(np.float32)
            p["w_q"] = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            p["w_scale"] = scale
        out.append(p)
    return out


def calibrate_conv_input_scales(graph, params: list, batches, *,
                                compute_dtype=None) -> dict:
    """Static int8 activation calibration: run inference over calibration
    `batches` (iterable of (B,H,W,C) arrays) recording each conv layer's
    input absmax; returns {layer_index: absmax} aggregated by max.

    The dynamic path (conv_block_int8 without "x_scale") computes this
    per forward like the reference re-binarizes per forward
    (convolutional_layer.cpp:1005); calibrating once offline is the
    deployment practice (TensorRT-style) and removes a full-tensor
    reduction barrier in front of every quantized conv.

    `params` should be post-fuse_conv_batchnorm (quantized or not).
    """
    import jax

    from darknet_tpu.nn.emit import make_forward

    fwd = jax.jit(make_forward(graph, fused_bn=True,
                               compute_dtype=compute_dtype,
                               probe_conv_absmax=True))
    agg: dict[int, float] = {}
    for x in batches:
        r = fwd(params, np.asarray(x, dtype=np.float32))
        for i, v in r["conv_in_absmax"].items():
            agg[i] = max(agg.get(i, 0.0), float(v))
    return agg


def apply_conv_input_scales(params: list, absmax: dict,
                            graph=None) -> list:
    """Attach static activation scales: p["x_scale"] = absmax/127 on every
    quantized conv (one with "w_q") whose index has a calibration entry.

    Pass `graph` when the net uses share_index weight sharing: a sharing
    call site reads the SOURCE layer's param dict (nn/emit.py), so its
    input range must be folded into the source's scale (max over all call
    sites — conservative, no saturation at any site)."""
    absmax = dict(absmax)
    if graph is not None:
        for l in graph.layers:
            if (getattr(l, "kind", None) == "convolutional"
                    and getattr(l, "share_index", None) is not None
                    and l.index in absmax):
                src = l.share_index
                absmax[src] = max(absmax.get(src, 0.0),
                                  float(absmax[l.index]))
    out = []
    for i, p in enumerate(params):
        if "w_q" in p and i in absmax:
            p = dict(p)
            p["x_scale"] = np.float32(max(float(absmax[i]), 1e-8) / 127.0)
        out.append(p)
    return out
