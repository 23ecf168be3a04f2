"""Gradient parity for the fused BN+activation training epilogue
(ops/train_epilogue.py) — the custom VJP must produce the same gradients
as plain autodiff of the identical forward math.  Reference semantics:
mean_cpu/variance_cpu (blas.c:164-201, Bessel 1/(N-1)) +
BackwardBatchnormLayer (batchnorm_layer.cpp:240-255)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from darknet_tpu.ops.activations import apply_activation
from darknet_tpu.ops.train_epilogue import BN_EPS, bn_act_train


def _plain(act, y, scales, beta):
    """Plain autodiff of the identical forward: no custom VJP."""
    b, h, w, _c = y.shape
    cnt = b * h * w
    mean = jnp.mean(y, axis=(0, 1, 2))
    sq = jnp.sum(jnp.square(y - mean), axis=(0, 1, 2))
    var = sq / max(cnt - 1, 1)
    inv = jax.lax.rsqrt(var + BN_EPS)
    y_norm = (y - mean) * inv * scales + beta
    return apply_activation(y_norm, act), (mean, var)


@pytest.mark.parametrize("act", ["mish", "leaky", "linear", "swish"])
@pytest.mark.parametrize("shape", [(2, 6, 4, 8), (1, 5, 7, 16),
                                   (4, 3, 3, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grad_matches_autodiff(act, shape):
    rng = np.random.default_rng(7)
    c = shape[-1]
    y = jnp.asarray(rng.normal(0, 2, shape).astype(np.float32))
    scales = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
    beta = jnp.asarray(rng.normal(0, 0.5, c).astype(np.float32))
    g = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32))

    def loss_fused(y, s, b):
        out, _ = bn_act_train(act, None, None, y, s, b)
        return jnp.sum(out * g)

    def loss_plain(y, s, b):
        out, _ = _plain(act, y, s, b)
        return jnp.sum(out * g)

    out_f, _ = bn_act_train(act, None, None, y, scales, beta)
    out_p, (mean_f, var_f) = _plain(act, y, scales, beta)
    np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_p),
                               rtol=2e-6, atol=2e-6)
    # stats match the plain forward's formulas
    out2, (mean2, var2) = bn_act_train(act, None, None, y, scales, beta)
    np.testing.assert_allclose(np.asarray(mean2), np.asarray(mean_f),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(var2), np.asarray(var_f),
                               rtol=1e-6, atol=1e-6)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(y, scales, beta)
    gp = jax.grad(loss_plain, argnums=(0, 1, 2))(y, scales, beta)
    for a, b_, name in zip(gf, gp, ["dy", "dscales", "dbeta"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b_), rtol=2e-4, atol=2e-5,
            err_msg=f"{name} mismatch (act={act}, shape={shape})")


def test_bf16_residual_close_to_f32():
    """res_dtype=bf16 stores y_hat at half width; gradients stay within
    mixed-precision tolerance of the f32-residual backward."""
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.normal(0, 2, (2, 8, 8, 16)).astype(np.float32))
    scales = jnp.asarray(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    beta = jnp.asarray(rng.normal(0, 0.5, 16).astype(np.float32))
    g = jnp.asarray(rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32))

    def loss(res_dtype):
        def f(y, s, b):
            out, _ = bn_act_train("mish", None, res_dtype, y, s, b)
            return jnp.sum(out * g)
        return jax.grad(f, argnums=(0, 1, 2))(y, scales, beta)

    gf = loss(None)
    gb = loss(jnp.bfloat16)
    for a, b_ in zip(gf, gb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=2e-2, atol=2e-2)


def test_out_dtype_cast():
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.normal(0, 1, (1, 4, 4, 8)).astype(np.float32))
    s = jnp.ones(8, jnp.float32)
    b = jnp.zeros(8, jnp.float32)
    out, _ = bn_act_train("leaky", jnp.bfloat16, None, y, s, b)
    assert out.dtype == jnp.bfloat16
    # backward accepts the bf16 cotangent
    def f(y):
        o, _ = bn_act_train("leaky", jnp.bfloat16, jnp.bfloat16, y, s, b)
        return jnp.sum(o.astype(jnp.float32))
    gy = jax.grad(f)(y)
    assert gy.dtype == jnp.float32 and np.isfinite(np.asarray(gy)).all()
