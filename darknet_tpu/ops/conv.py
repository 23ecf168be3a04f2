"""Convolution blocks: conv + bias/batchnorm + activation, NHWC.

The reference forwards a conv layer as im2col + GEMM (+cuDNN on GPU) with a
separate batch-norm pass and an activation epilogue
(`convolutional_layer.cpp:1128-1305`, `convolutional_kernels.cu:252-552`).
Here the whole block is one `lax.conv_general_dilated` (on the GPU, a cuDNN
NHWC convolution) with the BN/bias/activation fused into the epilogue by
XLA.

Numerics:
* inference BN uses rolling stats with ``sqrt(var + 1e-5)`` (the GPU/fused
  path, `blas_kernels.cu:144`, `network.cpp:660`);
* training BN computes batch mean/(biased) variance and updates rolling
  stats with 0.9/0.1 (`batchnorm_layer.cpp:221-224`);
* compute can run in bf16 (tensor cores) with f32 accumulation via
  ``preferred_element_type``; params stay f32.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from darknet_tpu.ops.activations import apply_activation

_DIMSPEC = ("NHWC", "HWIO", "NHWC")

BN_EPS = 1e-5


def conv2d_raw(x, w, *, stride=(1, 1), padding=((0, 0), (0, 0)),
               dilation=(1, 1), groups=1, compute_dtype=None,
               out_dtype=jnp.float32):
    """Plain convolution, NHWC x HWIO -> NHWC, f32 accumulation.

    When `compute_dtype` is None or float32 the op runs in full f32
    (Precision.HIGHEST: without it the GPU may run f32 convolutions in
    TF32, which breaks reference parity); pass bf16 for the fast
    tensor-core production path.  `out_dtype` must equal `compute_dtype`
    under autodiff (the conv transpose rule requires matching
    operand/cotangent dtypes).
    """
    precision = None
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
        if compute_dtype == jnp.float32:
            precision = lax.Precision.HIGHEST
    else:
        precision = lax.Precision.HIGHEST
        if x.dtype != w.dtype:
            # a reduced-precision interlayer tensor (train_act_dtype)
            # meeting the f32 parity path: conv requires matching dtypes
            x = x.astype(w.dtype)
    return lax.conv_general_dilated(
        x, w,
        window_strides=stride,
        padding=padding,
        rhs_dilation=dilation,
        dimension_numbers=_DIMSPEC,
        feature_group_count=groups,
        precision=precision,
        preferred_element_type=out_dtype,
    )


def darknet_conv_padding(size: int, pad: int, dilation: int,
                         in_hw, stride, out_hw) -> tuple:
    """Explicit (lo, hi) padding reproducing darknet's output size.

    Darknet computes ``out = (in + 2*pad - size)/stride + 1`` (ignoring
    dilation, `convolutional_layer.cpp:87-95`) but EXECUTES the conv
    with padding ``pad * dilation`` on every edge — both im2col_cpu_ext
    calls and the cuDNN descriptor scale it
    (`convolutional_layer.cpp:296-301,1249-1253`), which is what keeps a
    3x3 pad-1 dilated conv spatially centered.  XLA wants explicit
    per-edge padding; the low edge gets the reference's ``pad*dilation``
    and the high edge exactly what the output size formula requires.
    """
    (in_h, in_w), (s_y, s_x), (out_h, out_w) = in_hw, stride, out_hw
    eff = lambda k: dilation * (k - 1) + 1
    lo = pad * dilation
    hi_h = (out_h - 1) * s_y + eff(size) - in_h - lo
    hi_w = (out_w - 1) * s_x + eff(size) - in_w - lo
    return ((lo, max(hi_h, 0)), (lo, max(hi_w, 0)))


def batch_mean_var(y, axes):
    """Batch statistics matching mean_cpu/variance_cpu (blas.c:164-201):
    mean over batch*spatial, variance with Bessel's 1/(N-1) correction."""
    n = 1
    for a in axes:
        n *= y.shape[a]
    mean = jnp.mean(y, axis=axes)
    sq = jnp.sum(jnp.square(y - jnp.expand_dims(mean, axes)), axis=axes)
    var = sq / max(n - 1, 1)
    return mean, var


def fold_bn(w, b, scales, mean, var, eps: float = BN_EPS):
    """Fold rolling BN stats into conv weights+bias (FuseConvBatchNorm,
    network.cpp:647-682): ``w *= s/std; b = b - s*mean/std`` with
    ``std = sqrt(var + 1e-5)``.  w is HWIO; per-filter factors index O."""
    std = jnp.sqrt(var + eps)
    factor = scales / std
    w2 = w * factor[None, None, None, :]
    b2 = b - scales * mean / std
    return w2, b2


def conv_block_int8(x, p, l, *, compute_dtype=jnp.bfloat16):
    """Quantized inference conv: dynamic per-tensor activation int8 +
    per-output-channel weight int8, int32 accumulation, f32 dequant+bias
    epilogue, activation in the compute dtype.

    The analogue of the reference's XNOR/binary fast path (gemm.c:1334
    bit-GEMM, convolutional_layer.cpp:1005-1120): darknet binarizes
    dynamically per forward with a per-filter mean; int8 with per-channel
    absmax scales is the tensor-core equivalent.

    `p` must carry "w_q" (int8 HWIO) and "w_scale" ((N,) f32) from
    nn/params.quantize_conv_params; BN must already be folded.  When `p`
    also carries "x_scale" (a static per-tensor activation scale from
    nn/params.apply_conv_input_scales, the calibrated-deployment analogue
    of TensorRT's calibration pass), the dynamic absmax reduce is skipped
    entirely — the quantize step becomes pure elementwise work that XLA
    fuses into the producer's epilogue instead of a full-tensor reduction
    barrier per conv.
    """
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    if "x_scale" in p:
        x_scale = p["x_scale"]
    else:
        absmax = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-8)
        x_scale = absmax / 127.0
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / x_scale),
                   -127, 127).astype(jnp.int8)
    acc = lax.conv_general_dilated(
        x_q, p["w_q"],
        window_strides=(l.stride_y, l.stride_x),
        padding=padding,
        rhs_dilation=(l.dilation, l.dilation),
        dimension_numbers=_DIMSPEC,
        feature_group_count=l.groups,
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (x_scale * p["w_scale"]) + p["b"]
    y = y.astype(compute_dtype)
    y = apply_activation(y, l.activation)
    if getattr(l, "antialiasing", 0):
        y = antialias_blur(y, l)
    return y


def conv_block(x, p, l, *, train: bool = False, compute_dtype=None,
               res_dtype=None):
    """Full darknet conv layer: conv, then BN or bias, then activation.

    `p` is the layer's param dict ({"w","b"[,"scales","mean","var"]}).
    `l` is its ConvIR.  Returns (y, bn_stats) where bn_stats is
    (batch_mean, batch_var) when train and batch_normalize, else None —
    the caller threads them into rolling-stat updates.

    res_dtype (train+BN only): dtype of the single y_hat residual the
    fused epilogue backward stores (ops/train_epilogue.py) — bf16 under
    act16 halves the dominant residual traffic; None keeps f32.
    """
    padding = darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    # mixed-precision training: conv emits compute_dtype (cotangent dtype
    # must match operands under vjp); the BN/bias epilogue runs f32
    out_dtype = compute_dtype if (train and compute_dtype is not None) \
        else jnp.float32
    y = conv2d_raw(
        x, p["w"], stride=(l.stride_y, l.stride_x), padding=padding,
        dilation=(l.dilation, l.dilation), groups=l.groups,
        compute_dtype=compute_dtype, out_dtype=out_dtype)
    # act16 fast path (keep_lp): the conv output stays bf16 through the
    # fused BN+act epilogue — the f32 copy of every conv output (and its
    # f32 dy cotangent) never exists in HBM; stats still accumulate f32
    keep_lp = (train and res_dtype is not None and compute_dtype is not None
               and l.batch_normalize and "scales" in p)
    if train and compute_dtype is not None and not keep_lp:
        y = y.astype(jnp.float32)

    bn_stats = None
    if l.batch_normalize and "scales" in p:
        if train:
            # fused BN+act epilogue with custom VJP: the backward stores
            # ONE y_hat residual (at res_dtype) instead of the ~2
            # full-size f32 tensors plain autodiff saves — the dominant
            # HBM cost of the 608² train step (ops/train_epilogue.py)
            from darknet_tpu.ops.train_epilogue import bn_act_train

            y, bn_stats = bn_act_train(
                l.activation, res_dtype if keep_lp else None, res_dtype, y,
                p["scales"], p["b"])
            if getattr(l, "antialiasing", 0):
                y = antialias_blur(y, l)
            return y, bn_stats
        mean, var = p["mean"], p["var"]
        inv_std = lax.rsqrt(var + BN_EPS)
        y = (y - mean) * inv_std * p["scales"] + p["b"]
    else:
        y = y + p["b"]

    if compute_dtype is not None and not train:
        # fast path: run the activation (and the next layer's input) at the
        # compute dtype — half the bytes of f32
        y = y.astype(compute_dtype)
    y = apply_activation(y, l.activation)
    if getattr(l, "antialiasing", 0):
        y = antialias_blur(y, l)
    return y, bn_stats


def _blur_kernel(c: int, antialiasing: int, dtype=jnp.float32):
    """Depthwise blur weights (convolutional_layer.cpp:744-801)."""
    if antialiasing == 2:
        k = jnp.full((2, 2), 0.25, dtype=dtype)
    else:
        k1 = jnp.array([1.0, 2.0, 1.0], dtype=dtype) / 4.0
        k = jnp.outer(k1, k1)
    # HWIO with feature_group_count=c: (kh, kw, 1, c)
    return jnp.tile(k[:, :, None, None], (1, 1, 1, c))


def antialias_backref_view(y_act, blur, l):
    """The antialiased layer's output AS BACK-REFERENCES SEE IT.

    The reference threads the blur sublayer's dims to the NEXT layer
    (parser.cpp:1385-1391) — sequential flow sees the sane stride-s
    blurred tensor — but the layer struct keeps the stride-1 dims
    (FillConvLayer forces stride 1, convolutional_layer.cpp:419-423,496)
    and forward only memcpy's the blur output over the FRONT of the flat
    CHW buffer (convolutional_layer.cpp:1293-1303).  A route/shortcut/
    scale_channels back-reference therefore reads an (h, w, c) tensor
    whose flat front is the blurred output and whose tail is the stale
    stride-1 conv activations.  Bizarre but deterministic; reproduced
    flat-exactly so such cfgs keep reference shapes and values."""
    b, h, w, c = y_act.shape
    flat_full = jnp.transpose(y_act, (0, 3, 1, 2)).reshape(b, -1)
    flat_blur = jnp.transpose(blur, (0, 3, 1, 2)).reshape(b, -1)
    flat = jnp.concatenate(
        [flat_blur, flat_full[:, flat_blur.shape[1]:]], axis=1)
    return jnp.transpose(flat.reshape(b, c, h, w), (0, 2, 3, 1))


def antialias_blur(y, l):
    """Fixed depthwise blur at the layer's original stride."""
    c = y.shape[-1]
    size, pad = (2, 0) if l.antialiasing == 2 else (3, 1)
    in_h, in_w = y.shape[1], y.shape[2]
    out_h = (in_h + 2 * pad - size) // l.blur_stride_y + 1
    out_w = (in_w + 2 * pad - size) // l.blur_stride_x + 1
    padding = darknet_conv_padding(
        size, pad, 1, (in_h, in_w), (l.blur_stride_y, l.blur_stride_x),
        (out_h, out_w))
    return lax.conv_general_dilated(
        y, _blur_kernel(c, l.antialiasing, y.dtype),
        window_strides=(l.blur_stride_y, l.blur_stride_x),
        padding=padding,
        dimension_numbers=_DIMSPEC,
        feature_group_count=c,
        preferred_element_type=jnp.float32,
    )


def connected_block(x, p, l, *, train: bool = False, compute_dtype=None):
    """Fully-connected layer (connected_layer.cpp): y = x @ w + b, opt BN.

    Darknet weights index the input in CHW-flat order; spatial inputs are
    transposed from our NHWC before flattening so `.weights` files map
    element-for-element."""
    if x.ndim == 4:
        x = jnp.transpose(x, (0, 3, 1, 2))
    x2 = x.reshape(x.shape[0], -1)
    w = p["w"]
    precision = None
    if compute_dtype is not None:
        x2 = x2.astype(compute_dtype)
        w = w.astype(compute_dtype)
    else:
        precision = lax.Precision.HIGHEST
    y = jnp.dot(x2, w, precision=precision,
                preferred_element_type=jnp.float32)
    bn_stats = None
    if l.batch_normalize and "scales" in p:
        if train:
            mean, var = batch_mean_var(y, axes=(0,))
            bn_stats = (mean, var)
        else:
            mean, var = p["mean"], p["var"]
        inv_std = lax.rsqrt(var + BN_EPS)
        y = (y - mean) * inv_std * p["scales"] + p["b"]
    else:
        y = y + p["b"]
    y = apply_activation(y, l.activation)
    return y, bn_stats


def batchnorm_block(x, p, l, *, train: bool = False):
    """Standalone [batchnorm] layer (batchnorm_layer.cpp:206-238)."""
    bn_stats = None
    if train:
        mean, var = batch_mean_var(x, axes=(0, 1, 2))
        bn_stats = (mean, var)
    else:
        mean, var = p["mean"], p["var"]
    inv_std = lax.rsqrt(var + BN_EPS)
    y = (x - mean) * inv_std * p["scales"] + p["b"]
    return y, bn_stats
