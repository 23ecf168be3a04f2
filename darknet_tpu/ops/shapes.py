"""Shape/wiring ops: route, shortcut, upsample, reorg, scale_channels,
dropout/dropblock, crop.

These are the data-movement layers of the cfg dialect: pure jnp
reshapes/concats that XLA fuses into neighbours.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from darknet_tpu.ops.activations import apply_activation


def route(tensors: list, groups: int = 1, group_id: int = 0):
    """[route]: concat along channels; with groups, keep 1/groups slice of
    each input (CSP partial concat, route_layer.c:95-103)."""
    if groups > 1:
        sliced = []
        for t in tensors:
            part = t.shape[-1] // groups
            sliced.append(t[..., group_id * part:(group_id + 1) * part])
        tensors = sliced
    if len(tensors) == 1:
        return tensors[0]
    return jnp.concatenate(tensors, axis=-1)


def shortcut(x, from_tensor, activation: str = "linear"):
    """[shortcut]: elementwise add + activation (shortcut_layer.c:145-177).

    Channel-count mismatch (same spatial dims): the reference's GPU
    kernel guards the add by flat CHW index
    (`blas_kernels.cu shortcut_singlelayer_simple_kernel`:
    `if (src_i < add_outputs)`), which with equal H/W is exactly a
    channel-PREFIX add — the first min(c_in, c_from) channels add, the
    rest pass through.  Its CPU path instead prints "something went
    wrong" and leaves the output buffer unwritten (stale memory) —
    another CPU/GPU self-inconsistency; we match the GPU/defined
    semantics (PARITY.md DEVIATIONS #16)."""
    c_in, c_from = x.shape[-1], from_tensor.shape[-1]
    if c_in == c_from:
        y = x + from_tensor
    elif c_from < c_in:
        y = x.at[..., :c_from].add(from_tensor)
    else:
        y = x + from_tensor[..., :c_in]
    return apply_activation(y, activation)


def upsample(x, stride: int, scale: float = 1.0):
    """[upsample]: nearest-neighbour x stride, then scalar scale
    (upsample_layer.c, blas.c upsample_cpu)."""
    b, h, w, c = x.shape
    y = jnp.repeat(jnp.repeat(x, stride, axis=1), stride, axis=2)
    if scale != 1.0:
        y = y * scale
    return y


def upsample_reverse(x, stride: int, scale: float = 1.0):
    """Reverse upsample (downsample): picks the top-left of each block and
    scales — upsample_cpu with forward=0 sums src into dst; for the forward
    network path reverse mode averages are not used by any known cfg, so we
    implement the sum-of-block semantics exactly."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // stride, stride, w // stride, stride, c)
    y = jnp.sum(y, axis=(2, 4))
    if scale != 1.0:
        y = y * scale
    return y


def _reorg_perm_chw(dims, stride, forward):
    """Exact flat permutation of blas.c `reorg_cpu` (blas.c:12-44) in CHW
    index space.  `dims` = (C, H, W) the loop bounds (out_c/out_h/out_w
    arguments).  Returns `perm` such that out_flat = x_flat[perm] when
    forward==0 (out[in_index]=x[out_index]) — or the scatter inverse when
    forward==1.  Computed once with numpy at trace time (static shapes)."""
    import numpy as np

    C, H, W = dims
    s = stride
    in_c = C // (s * s)
    k = np.arange(C)[:, None, None]
    j = np.arange(H)[None, :, None]
    i = np.arange(W)[None, None, :]
    in_index = i + W * (j + H * k)
    c2 = k % in_c
    offset = k // in_c
    w2 = i * s + offset % s
    h2 = j * s + offset // s
    out_index = w2 + W * s * (h2 + H * s * c2)
    if forward:
        # out[out_index] = x[in_index] is a scatter; invert it to a gather
        perm = np.zeros(int(out_index.max()) + 1, dtype=np.int64)
        perm[np.broadcast_to(out_index, in_index.shape).ravel()] = \
            np.broadcast_to(in_index, out_index.shape).ravel()
        return perm
    return np.broadcast_to(out_index, (C, H, W)).ravel()


def _apply_chw_perm(x, perm):
    """Apply a flat CHW permutation to an NHWC tensor, reshaping back."""
    b, h, w, c = x.shape
    x_chw = jnp.transpose(x, (0, 3, 1, 2)).reshape(b, -1)
    y = jnp.take(x_chw, jnp.asarray(perm), axis=1)
    n = perm.shape[0]
    return y, n


def reorg3d(x, stride: int, reverse: bool = False, out_shape=None):
    """[reorg3d] space-to-depth (reorg_layer.c:87-99).

    Non-reverse (the common yolov2/v3 usage) lowers to a pure
    reshape+transpose: output channel ``k = c2 + c*(dy*s + dx)`` at (j, i)
    reads input channel c2 at pixel (j*s + dy, i*s + dx).  Reverse mode uses
    the exact flat permutation of `reorg_cpu` with forward=1.
    """
    b, h, w, c = x.shape
    s = stride
    if not reverse:
        oh, ow = h // s, w // s
        y = x.reshape(b, oh, s, ow, s, c)           # (b, j, dy, i, dx, c2)
        y = jnp.transpose(y, (0, 1, 3, 2, 4, 5))     # (b, j, i, dy, dx, c2)
        return y.reshape(b, oh, ow, s * s * c)
    # reverse: ForwardReorgLayer calls reorg_cpu(out_dims, forward=1)
    oh, ow, oc = out_shape if out_shape else (h * s, w * s, c // (s * s))
    perm = _reorg_perm_chw((oc, oh, ow), s, forward=True)
    y, n = _apply_chw_perm(x, perm)
    return jnp.transpose(y.reshape(b, oc, oh, ow), (0, 2, 3, 1))


def reorg_old(x, stride: int, reverse: bool = False, out_shape=None):
    """[reorg] legacy variant (reorg_old_layer.c:87-93): calls `reorg_cpu`
    with the layer's INPUT dims — the famous flat-reinterpretation quirk of
    old darknet.  Replicated exactly via the static permutation."""
    b, h, w, c = x.shape
    perm = _reorg_perm_chw((c, h, w), stride, forward=bool(reverse))
    y, n = _apply_chw_perm(x, perm)
    oh, ow, oc = out_shape if out_shape else (
        (h // stride, w // stride, c * stride * stride) if not reverse
        else (h * stride, w * stride, c // (stride * stride)))
    return jnp.transpose(y.reshape(b, oc, oh, ow), (0, 2, 3, 1))


def scale_channels(gate, feature, scale_wh: bool = False,
                   activation: str = "linear"):
    """[scale_channels] (scale_channels_layer.c:72-100): out = feature * gate.

    Channel mode: gate is (B,1,1,C) broadcast over feature's H,W.
    scale_wh mode: gate is (B,H,W,1) broadcast over channels.
    The optional activation applies to the product.
    """
    y = feature * gate
    return apply_activation(y, activation)


def dropout(x, rng, probability: float):
    """Inverted dropout (dropout_layer.c:89-105): drop with p, scale kept
    values by 1/(1-p)."""
    keep = jax.random.bernoulli(rng, 1.0 - probability, x.shape)
    return jnp.where(keep, x / (1.0 - probability), 0.0)


def dropblock(x, rng, probability: float, block_size_abs: int,
              block_size_rel: float):
    """DropBlock (dropout_layer.c dropblock branch): zero contiguous
    block_size x block_size regions; the per-seed drop rate is scaled so the
    expected dropped fraction matches `probability`."""
    b, h, w, c = x.shape
    if block_size_abs:
        bs = min(block_size_abs, min(h, w))
    else:
        bs = max(1, int(block_size_rel * min(h, w)))
    # seed rate gamma: p / bs^2 (standard DropBlock; reference computes the
    # same expectation on the fly)
    gamma = probability / float(bs * bs)
    seeds = jax.random.bernoulli(rng, gamma, (b, h, w, 1)).astype(x.dtype)
    # grow each seed to a bs x bs block with a max-pool
    from jax import lax
    pad = bs // 2
    mask = lax.reduce_window(
        seeds, jnp.array(0.0, x.dtype), lax.max,
        window_dimensions=(1, bs, bs, 1), window_strides=(1, 1, 1, 1),
        padding=((0, 0), (pad, bs - 1 - pad), (pad, bs - 1 - pad), (0, 0)))
    keep = 1.0 - mask
    denom = jnp.maximum(jnp.mean(keep, axis=(1, 2, 3), keepdims=True), 1e-6)
    return x * keep / denom


def crop_layer(x, l, *, train: bool = False, rng=None):
    """[crop] (crop_layer.c:63-101, ForwardCropLayer).

    Train: ONE random crop offset + one flip draw for the whole batch
    (the reference draws rand() once outside the b/c/i/j loops,
    crop_layer.c:65-67).  Inference: deterministic center crop, no flip.
    Both modes map pixels through `out = in * 2 - 1` unless noadjust=1
    (crop_layer.c:68-75 — scale/trans apply regardless of train)."""
    import jax
    from jax import lax

    b, h, w, c = x.shape
    oh, ow = l.crop_height, l.crop_width
    if train and rng is not None:
        kf, kh, kw = jax.random.split(rng, 3)
        dh = jax.random.randint(kh, (), 0, h - oh + 1)
        dw = jax.random.randint(kw, (), 0, w - ow + 1)
        if l.flip:
            flip = jax.random.bernoulli(kf)
            # flipped output col j reads input col (w-dw-1-j)
            # == column (dw+j) of the horizontally reversed image, so a
            # flip is the same dynamic_slice on the flipped input
            x = jnp.where(flip, jnp.flip(x, axis=2), x)
        out = lax.dynamic_slice(x, (0, dh, dw, 0), (b, oh, ow, c))
    else:
        dh = (h - oh) // 2
        dw = (w - ow) // 2
        out = x[:, dh:dh + oh, dw:dw + ow, :]
    if not l.noadjust:
        out = out * 2.0 - 1.0
    return out
