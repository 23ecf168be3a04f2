"""Pooling ops: maxpool (spatial + depth modes), global avgpool.

Reference semantics (`maxpool_layer.cpp:214-300`):

* spatial maxpool: ``out = (in + pad - size)//stride + 1`` with the window
  origin offset by ``-pad//2``; out-of-range taps contribute -inf;
* `maxpool_depth`: max over channel groups at each spatial position —
  channel k maps to output channel ``k % out_c``;
* global avgpool (`avgpool_layer.cpp`): mean over H,W.

Implemented with `lax.reduce_window`, which XLA lowers to the VPU with an
efficient derivative (no explicit argmax indices needed — the reference only
keeps `indexes` for its hand-written backward).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from darknet_tpu.ops.conv import antialias_blur


# ------------------------------------------------------- stride-1 maxpool
# The SPP block's 5/9/13 stride-1 pools dominate training-time pooling
# cost: autodiff of a max chain (or reduce_window) lowers the backward to
# select-and-scatter / pad+add chains, which serialize on scatters.
# Custom VJP:
# forward is one reduce_window pass; backward distributes each window's
# cotangent to the positions equal to the window max via size^2 shifted
# fused multiply-adds — no scatter.  Gradient equals the reference's
# (maxpool_layer.cpp backward: route to argmax) whenever the window max is
# unique, which holds w.p. 1 on conv outputs; on exact ties every tied
# position receives the full cotangent (the reference picks the first —
# ties are measure-zero and PARITY.md documents the deviation).

@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3, 4))
def _maxpool_s1_axis(x, axis, size, lo, hi):
    """Stride-1 max over a 1-D window along `axis` (1=H, 2=W)."""
    neg_inf = jnp.array(-jnp.inf, dtype=x.dtype)
    dims = [1, 1, 1, 1]
    dims[axis] = size
    pad = [(0, 0)] * 4
    pad[axis] = (lo, hi)
    return lax.reduce_window(
        x, neg_inf, lax.max,
        window_dimensions=tuple(dims),
        window_strides=(1, 1, 1, 1),
        padding=tuple(pad))


def _maxpool_s1_axis_fwd(x, axis, size, lo, hi):
    y = _maxpool_s1_axis(x, axis, size, lo, hi)
    return y, (x, y)


def _maxpool_s1_axis_bwd(axis, size, lo, hi, res, g):
    x, y = res
    n = x.shape[axis]
    # window a covers padded positions a..a+size-1; input position i
    # (= padded i+lo) is in windows a = i+lo-o, o in [0, size).  Pad g
    # and y so every (i, o) lands in-range: padded index i + (size-1-o).
    pre = size - 1 - lo
    post = n + lo - y.shape[axis]
    pad = [(0, 0)] * 4
    pad[axis] = (pre, post)
    gp = jnp.pad(g, pad)
    yp = jnp.pad(y, pad)
    dx = jnp.zeros_like(x)
    starts0 = [0, 0, 0, 0]
    limits0 = list(x.shape)
    for o in range(size):
        i0 = size - 1 - o
        starts = list(starts0)
        limits = list(limits0)
        starts[axis] = i0
        limits[axis] = i0 + n
        ys = lax.slice(yp, starts, limits)
        gs = lax.slice(gp, starts, limits)
        # padded y is 0 where no window exists; gs is 0 there too, so
        # a spurious x==0 match contributes nothing
        dx = dx + gs * (x == ys).astype(g.dtype)
    return (dx,)


_maxpool_s1_axis.defvjp(_maxpool_s1_axis_fwd, _maxpool_s1_axis_bwd)


def _maxpool_s1(x, size, lo, hi_h, hi_w):
    """Separable stride-1 maxpool: max over the size x size rectangle ==
    max over rows of the column-wise maxes.  Forward is exact (max is
    associative); the backward runs 2*size shifted compare-FMAs instead
    of the naive size^2 — the SPP block's 13x13 pool drops from 169 taps
    to 26 (its serialized tap chain was 2.55 ms of the 72 ms yolov4-608
    b8 train step).  Tie semantics: on an exact tie the cotangent routes
    to every position matching the row-then-column max (the reference
    routes to the first argmax; ties are measure-zero on conv outputs —
    PARITY.md DEVIATIONS)."""
    y = _maxpool_s1_axis(x, 1, size, lo, hi_h)
    return _maxpool_s1_axis(y, 2, size, lo, hi_w)


def maxpool(x, l, train: bool = False):
    """Darknet maxpool on NHWC input, per MaxpoolIR `l`.

    Inference uses `lax.reduce_window` (one fused VPU pass — essential for
    the SPP's 13x13 stride-1 pools); training uses the equivalent max of
    shifted slices, which has a reverse-mode derivative.
    """
    if l.maxpool_depth:
        b, h, w, c = x.shape
        out_c = l.out_channels
        groups = -(-c // out_c)              # ceil; c % out_c == 0 in practice
        pad_c = groups * out_c - c
        if pad_c:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, pad_c)),
                        constant_values=-jnp.inf)
        # channel k -> (group k//out_c, slot k%out_c): reduce over groups
        y = x.reshape(b, h, w, groups, out_c)
        return jnp.max(y, axis=3)

    lo = l.pad // 2
    hi_h = max((l.out_h - 1) * l.stride_y + l.size - l.h - lo, 0)
    hi_w = max((l.out_w - 1) * l.stride_x + l.size - l.w - lo, 0)
    if not train:
        neg_inf = jnp.array(-jnp.inf, dtype=x.dtype)
        return lax.reduce_window(
            x, neg_inf, lax.max,
            window_dimensions=(1, l.size, l.size, 1),
            window_strides=(1, l.stride_y, l.stride_x, 1),
            padding=((0, 0), (lo, hi_h), (lo, hi_w), (0, 0)),
        )
    if (l.stride_y == 1 and l.stride_x == 1 and lo <= l.size - 1
            and x.shape[1] + lo >= l.out_h and x.shape[2] + lo >= l.out_w):
        # SPP-style stride-1 pool: custom VJP (scatter-free backward)
        return _maxpool_s1(x, l.size, lo, hi_h, hi_w)
    # strided training pools (2x2 in the tiny models): max over size^2
    # shifted strided slices — same result, reverse-mode differentiable
    # (reduce_window has no VJP here) and cheap at size 2
    xp = jnp.pad(x, ((0, 0), (lo, hi_h), (lo, hi_w), (0, 0)),
                 constant_values=-jnp.inf)
    out = None
    for dy in range(l.size):
        for dx in range(l.size):
            s = xp[:, dy:dy + (l.out_h - 1) * l.stride_y + 1:l.stride_y,
                   dx:dx + (l.out_w - 1) * l.stride_x + 1:l.stride_x, :]
            out = s if out is None else jnp.maximum(out, s)
    return out


def maxpool_block(x, l, train: bool = False):
    y = maxpool(x, l, train=train)
    if l.antialiasing:
        y = antialias_blur(y, l)
    return y


def global_avgpool(x):
    """[avgpool]: NHWC -> (N, 1, 1, C) mean over spatial dims."""
    return jnp.mean(x, axis=(1, 2), keepdims=True)
