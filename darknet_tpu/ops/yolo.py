"""YOLO v3/v4 and Gaussian-YOLO head ops: activation + on-device box decode.

Layout: the conv feeding a head emits NHWC ``(B, H, W, A*E)`` where darknet's
channel order is anchor-major, entry-major: channel ``a*E + e`` holds entry
``e`` of anchor ``a`` (E = 5+classes for [yolo], 9+classes for
[Gaussian_yolo]).  We reshape to ``(B, H, W, A, E)``.

Reference numerics:
* [yolo] forward (yolo_layer.cpp:388-407): logistic on x,y then the
  ``scale_x_y`` affine ``v*a - 0.5*(a-1)``; logistic on obj+classes; w,h raw.
* box decode (GetYoloBox, yolo_layer.cpp:139-147):
  ``bx=(col+x)/W, by=(row+y)/H, bw=exp(tw)*anchor_w/net_w,
  bh=exp(th)*anchor_h/net_h`` — all relative coordinates.
* Gaussian head (gaussian_yolo_layer.cpp:480-517, 866-891): entries are
  [mu_x, sig_x, mu_y, sig_y, mu_w, sig_w, mu_h, sig_h, obj, cls...];
  logistic on mu_x,sig_x,mu_y,sig_y,sig_w,sig_h,obj,cls; `scale_x_y` on
  mu_x/mu_y only; detection prob is scaled by ``(1 - mean(sigma))``
  (gaussian_yolo_layer.cpp:917-924) and boxes shift by ``yolo_point``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _split_entries(x, n_anchors: int, n_entries: int):
    b, h, w, c = x.shape
    assert c == n_anchors * n_entries, (c, n_anchors, n_entries)
    return x.reshape(b, h, w, n_anchors, n_entries)


def yolo_activate(x, l):
    """Raw head conv output -> activated output (same NHWC shape).

    Equivalent to ForwardYoloLayer's inference path.
    """
    e = 4 + 1 + l.classes
    v = _split_entries(x, l.n, e)
    xy = jax.nn.sigmoid(v[..., 0:2])
    if l.scale_x_y != 1.0:
        xy = xy * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0)
    wh = v[..., 2:4]
    objcls = jax.nn.sigmoid(v[..., 4:])
    out = jnp.concatenate([xy, wh, objcls], axis=-1)
    return out.reshape(x.shape)


def yolo_decode(activated, l, net_w: int, net_h: int,
                order: str = "reference", score_dtype=None,
                layout: str = "packed"):
    """Activated head output -> (boxes, obj, cls_prob) with relative coords.

    boxes: (B, H*W*A, 4) center-format (x, y, w, h); obj: (B, H*W*A);
    cls: (B, H*W*A, classes).

    order="reference" matches GetYoloDetections' loop (anchor-major then
    row-major spatial) for index-wise comparability with the reference
    binary.  order="native" flattens (H, W, A) directly — no transposes
    (which relayout ~100MB+ per batch at 608²) — for the production path
    where box ordering is immaterial (NMS sorts by score anyway).

    score_dtype (e.g. bf16) applies to obj/cls only — scores are
    probabilities used for ranking/thresholding, where bf16's ~3 decimal
    digits suffice; it halves the dominant HBM stream (cls is
    B x HWA x classes, by far the largest decode output).  Boxes stay f32:
    NMS IoU and the mAP gates need full coordinate precision.

    layout="planar" (order="native" only) returns boxes as a 4-tuple of
    (B, H*W*A) f32 arrays instead of one (B, H*W*A, 4) array: each
    coordinate is contiguous, and box math (IoU, NMS) consumes
    per-coordinate vectors anyway.
    """
    e = 4 + 1 + l.classes
    b, h, w, _ = activated.shape
    v = _split_entries(activated, l.n, e)

    f32 = jnp.float32
    cols = jnp.arange(w, dtype=f32)[None, None, :, None]
    rows = jnp.arange(h, dtype=f32)[None, :, None, None]
    anchors = jnp.asarray(l.anchors, dtype=f32).reshape(-1, 2)
    aw = anchors[jnp.asarray(l.mask), 0][None, None, None, :]
    ah = anchors[jnp.asarray(l.mask), 1][None, None, None, :]

    bx = (cols + v[..., 0].astype(f32)) / w
    by = (rows + v[..., 1].astype(f32)) / h
    bw = jnp.exp(v[..., 2].astype(f32)) * aw / net_w
    bh = jnp.exp(v[..., 3].astype(f32)) * ah / net_h
    obj = v[..., 4]
    cls = v[..., 5:]
    if score_dtype is not None:
        obj = obj.astype(score_dtype)
        cls = cls.astype(score_dtype)

    if layout == "planar":
        assert order == "native", "planar layout implies native order"
        return (tuple(v.reshape(b, -1) for v in (bx, by, bw, bh)),
                obj.reshape(b, -1), cls.reshape(b, -1, l.classes))
    boxes = jnp.stack([bx, by, bw, bh], axis=-1)       # (B,H,W,A,4)
    if order == "native":
        return (boxes.reshape(b, -1, 4), obj.reshape(b, -1),
                cls.reshape(b, -1, l.classes))
    # flatten anchor-major: (A, H, W) order like EntryIndex
    boxes = jnp.transpose(boxes, (0, 3, 1, 2, 4)).reshape(b, -1, 4)
    obj = jnp.transpose(obj, (0, 3, 1, 2)).reshape(b, -1)
    cls = jnp.transpose(cls, (0, 3, 1, 2, 4)).reshape(b, -1, l.classes)
    return boxes, obj, cls


# --------------------------------------------------------------------------
# Gaussian-YOLO
# --------------------------------------------------------------------------

_G_ENTRIES = 9  # mu/sigma x4 + obj


def gaussian_yolo_activate(x, l):
    """ForwardGaussianYoloLayer inference activations
    (gaussian_yolo_layer.cpp:491-517)."""
    e = _G_ENTRIES + l.classes
    v = _split_entries(x, l.n, e)
    mu_x = jax.nn.sigmoid(v[..., 0])
    sig_x = jax.nn.sigmoid(v[..., 1])
    mu_y = jax.nn.sigmoid(v[..., 2])
    sig_y = jax.nn.sigmoid(v[..., 3])
    if l.scale_x_y != 1.0:
        mu_x = mu_x * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0)
        mu_y = mu_y * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0)
    mu_w = v[..., 4]
    sig_w = jax.nn.sigmoid(v[..., 5])
    mu_h = v[..., 6]
    sig_h = jax.nn.sigmoid(v[..., 7])
    objcls = jax.nn.sigmoid(v[..., 8:])
    out = jnp.concatenate(
        [mu_x[..., None], sig_x[..., None], mu_y[..., None], sig_y[..., None],
         mu_w[..., None], sig_w[..., None], mu_h[..., None], sig_h[..., None],
         objcls], axis=-1)
    return out.reshape(x.shape)


def gaussian_yolo_decode(activated, l, net_w: int, net_h: int,
                         order: str = "reference", score_dtype=None):
    """Decode with uncertainty: returns (boxes, obj, cls, uc) where
    `uc` is (B, N, 4) sigma values and cls is ALREADY scaled by
    ``(1 - uc_avg)`` per GetGaussianYoloDetections (the caller multiplies by
    obj and thresholds).

    order / score_dtype as in yolo_decode: "native" skips the anchor-major
    transposes; score_dtype casts obj/cls (boxes and uc stay f32)."""
    e = _G_ENTRIES + l.classes
    b, h, w, _ = activated.shape
    v = _split_entries(activated, l.n, e)

    cols = jnp.arange(w, dtype=jnp.float32)[None, None, :, None]
    rows = jnp.arange(h, dtype=jnp.float32)[None, :, None, None]
    anchors = jnp.asarray(l.anchors, dtype=jnp.float32).reshape(-1, 2)
    aw = anchors[jnp.asarray(l.mask), 0][None, None, None, :]
    ah = anchors[jnp.asarray(l.mask), 1][None, None, None, :]

    bw = jnp.exp(v[..., 4]) * aw / net_w
    bh = jnp.exp(v[..., 6]) * ah / net_h
    bx = (cols + v[..., 0]) / w
    by = (rows + v[..., 2]) / h
    if l.yolo_point == "left_top":
        bx = bx + bw / 2
        by = by + bh / 2
    elif l.yolo_point == "right_bottom":
        bx = bx - bw / 2
        by = by - bh / 2

    obj = v[..., 8]
    uc = jnp.stack([v[..., 1], v[..., 3], v[..., 5], v[..., 7]], axis=-1)
    uc_avg = jnp.mean(uc, axis=-1, keepdims=True)
    cls = v[..., 9:] * (1.0 - uc_avg)

    if score_dtype is not None:
        obj = obj.astype(score_dtype)
        cls = cls.astype(score_dtype)
    boxes = jnp.stack([bx, by, bw, bh], axis=-1)
    if order == "native":
        return (boxes.reshape(b, -1, 4), obj.reshape(b, -1),
                cls.reshape(b, -1, l.classes), uc.reshape(b, -1, 4))
    boxes = jnp.transpose(boxes, (0, 3, 1, 2, 4)).reshape(b, -1, 4)
    obj = jnp.transpose(obj, (0, 3, 1, 2)).reshape(b, -1)
    cls = jnp.transpose(cls, (0, 3, 1, 2, 4)).reshape(b, -1, l.classes)
    uc = jnp.transpose(uc, (0, 3, 1, 2, 4)).reshape(b, -1, 4)
    return boxes, obj, cls, uc
