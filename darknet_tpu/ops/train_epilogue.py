"""Fused batch-norm + activation TRAINING epilogue with a hand-written
VJP — the HBM-traffic fix for the backward pass.

Problem: in the yolov4-608 train step the backward of every conv's
BN+activation epilogue is memory-bound.  Under plain autodiff the epilogue

    y (f32 conv out) -> batch stats -> normalize -> mish -> [bf16 cast]

saves ~two FULL-SIZE f32 residuals per conv (the pre-normalize tensor for
the BN backward and the pre-activation tensor for the mish gradient) even
when the interlayer tensors are bf16 — at 608² that is gigabytes of
residual traffic per step.  The reference solves the same problem with
cudnnBatchNormalizationBackward's fused kernel
(convolutional_kernels.cu:555+); here a custom VJP stores ONE residual — the normalized tensor y_hat, at the
training activation dtype (bf16 under act16) — and recomputes everything
else in the backward from it plus the per-channel vectors.

Backward math (exact analytic gradient of the forward expressions,
including Bessel's 1/(M-1) in the variance, matching
ops/conv.batch_mean_var == mean_cpu/variance_cpu, blas.c:164-201):

    gp   = dL/dy_norm = act_vjp(g)          (act recomputed from y_hat)
    gpg  = gp * gamma
    s1   = sum(gpg);   s2 = sum(gpg * y_hat)     (per channel, over
                                                  batch*spatial)
    dy   = inv_std * (gpg - s1/M - y_hat * s2/(M-1))
    dgamma = sum(gp * y_hat);  dbeta = sum(gp)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from darknet_tpu.ops.activations import apply_activation

BN_EPS = 1e-5   # == ops/conv.BN_EPS (kept local to avoid an import cycle)


def _fwd_math(y, scales, beta):
    """Shared forward: returns (y_hat, y_norm, mean, var, inv).

    y may be bf16 (the act16 fast path: the conv emits bf16 and the full
    f32 tensor never exists in HBM) — statistics accumulate in f32 via a
    convert-fused reduce, everything elementwise upcasts on the fly."""
    b, h, w, _c = y.shape
    yf = y.astype(jnp.float32)
    cnt = b * h * w
    if y.dtype == jnp.float32:
        # parity path: the reference's exact two-pass formula
        # (mean_cpu/variance_cpu, blas.c:164-201)
        mean = jnp.mean(yf, axis=(0, 1, 2))
        sq = jnp.sum(jnp.square(yf - mean), axis=(0, 1, 2))
        var = sq / max(cnt - 1, 1)
    else:
        # fast path (bf16 conv output): SINGLE-PASS two-moment stats —
        # sum and sum-of-squares in one fused read of y, var from
        # E[y²]-mean² (f32 accumulation; same Bessel).  The two-pass
        # formula costs one extra full read of every conv output per
        # step, which at 608² is pure HBM time.
        s1 = jnp.sum(yf, axis=(0, 1, 2))
        s2 = jnp.sum(jnp.square(yf), axis=(0, 1, 2))
        mean = s1 / cnt
        var = jnp.maximum(s2 - s1 * mean, 0.0) / max(cnt - 1, 1)
    inv = lax.rsqrt(var + BN_EPS)
    y_hat = (yf - mean) * inv
    y_norm = y_hat * scales.astype(jnp.float32) + beta.astype(jnp.float32)
    return y_hat, y_norm, mean, var, inv


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def bn_act_train(act, out_dtype, res_dtype, y, scales, beta):
    """(out, (mean, var)) = act(batchnorm(y)) with live batch statistics.

    y: (B,H,W,C) conv output; scales/beta: (C,).
    out is cast to `out_dtype` (None keeps f32); the backward stores
    y_hat at `res_dtype` (None keeps f32 — bf16 under act16 halves the
    only full-size residual).  mean/var are returned for the rolling-stat
    update and are NOT differentiated through (they are aux outputs in
    the train step — train/step.py's has_aux vjp).
    """
    _y_hat, y_norm, mean, var, _inv = _fwd_math(y, scales, beta)
    out = apply_activation(y_norm, act)
    if out_dtype is not None:
        out = out.astype(out_dtype)
    return out, (mean, var)


def _bn_act_fwd(act, out_dtype, res_dtype, y, scales, beta):
    y_hat, y_norm, mean, var, inv = _fwd_math(y, scales, beta)
    out = apply_activation(y_norm, act)
    if out_dtype is not None:
        out = out.astype(out_dtype)
    res_hat = y_hat if res_dtype is None else y_hat.astype(res_dtype)
    # zero-size dtype witness: the dy cotangent must match y's dtype
    # (bf16 on the act16 fast path, f32 on the parity path)
    return (out, (mean, var)), (res_hat, inv, scales, beta,
                                jnp.zeros((), y.dtype))


def _bn_act_bwd(act, out_dtype, res_dtype, res, cts):
    g, _g_stats = cts                 # stats are aux: cotangent ignored
    res_hat, inv, scales, beta, y_proto = res
    b, h, w, _c = res_hat.shape
    cnt = b * h * w
    y_hat = res_hat.astype(jnp.float32)
    s_f = scales.astype(jnp.float32)
    # recompute the activation input and pull the cotangent through the
    # activation (elementwise; fused by XLA — no residual was stored)
    y_norm = y_hat * s_f + beta.astype(jnp.float32)
    _out, act_vjp = jax.vjp(lambda t: apply_activation(t, act), y_norm)
    (gp,) = act_vjp(g.astype(jnp.float32))

    d_beta = jnp.sum(gp, axis=(0, 1, 2))
    d_scales = jnp.sum(gp * y_hat, axis=(0, 1, 2))
    gpg = gp * s_f
    s1 = jnp.sum(gpg, axis=(0, 1, 2))
    s2 = d_scales * s_f               # == sum(gpg * y_hat) exactly
    dy = inv * (gpg - s1 / cnt - y_hat * (s2 / max(cnt - 1, 1)))
    dy = dy.astype(y_proto.dtype)
    return (dy, d_scales.astype(scales.dtype), d_beta.astype(beta.dtype))


bn_act_train.defvjp(_bn_act_fwd, _bn_act_bwd)
