"""Image I/O and geometry, mirroring the reference's image pipeline.

The reference represents images as CHW float32 in [0,1], RGB
(`image.h:19-25`); loading goes through stb or OpenCV (`image_opencv.cpp:
205-247`), and *inference* resizing is a plain bilinear resize — NO
letterbox (`yolo_core.cpp:104-110` uses cv::resize).  We use HWC float32
RGB in [0,1] (channels-last, like the NHWC runtime tensors) and provide
both the darknet
`resize_image` bilinear (exact match for parity tests) and fast OpenCV
resize for the production path.
"""

from __future__ import annotations

import numpy as np


def load_image_rgb(path) -> np.ndarray:
    """Load an image file -> HWC float32 RGB in [0,1]."""
    try:
        import cv2

        m = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if m is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(m, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    except ImportError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def resize_image_darknet(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Exact port of the reference's two-pass bilinear `resize_image`
    (image.cpp): first horizontal, then vertical, with edge clamping on the
    last column.  im is HWC float32."""
    ih, iw, c = im.shape
    if (iw, ih) == (w, h):
        return im.copy()
    w_scale = np.float32((iw - 1) / (w - 1)) if w > 1 else np.float32(0)
    h_scale = np.float32((ih - 1) / (h - 1)) if h > 1 else np.float32(0)

    # horizontal pass -> (ih, w, c): last output column (or 1-wide input)
    # copies the input's last column verbatim (image.cpp:594-597)
    sx = np.arange(w, dtype=np.float32) * w_scale
    ix = sx.astype(np.int64)
    dx = (sx - ix).astype(np.float32)
    ix1 = np.minimum(ix + 1, iw - 1)
    part = (1 - dx)[None, :, None] * im[:, np.minimum(ix, iw - 1), :] + \
        dx[None, :, None] * im[:, ix1, :]
    last_col = (np.arange(w) == w - 1) | (iw == 1)
    part[:, last_col, :] = im[:, iw - 1:iw, :]

    # vertical pass -> (h, w, c): second tap skipped on the last row
    # (image.cpp:619-626)
    sy = np.arange(h, dtype=np.float32) * h_scale
    iy = sy.astype(np.int64)
    dy = (sy - iy).astype(np.float32)
    iy0 = np.minimum(iy, ih - 1)
    iy1 = np.minimum(iy + 1, ih - 1)
    out = (1 - dy)[:, None, None] * part[iy0, :, :]
    skip = (np.arange(h) == h - 1) | (ih == 1)
    out += np.where(skip[:, None, None], 0.0,
                    dy[:, None, None] * part[iy1, :, :])
    return out.astype(np.float32)


def resize_image_cv(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv::resize INTER_LINEAR — the reference CLI's inference path."""
    import cv2

    return cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)


def correct_boxes_letterbox(boxes, img_w: int, img_h: int, net_w: int,
                            net_h: int):
    """Map relative center-format boxes from letterboxed net coords back to
    original-image relative coords (the upstream correct_yolo_boxes
    analogue; this reference fork never letterboxes, so this exists for our
    optional letterbox path)."""
    import numpy as _np

    boxes = _np.asarray(boxes, dtype=_np.float32).copy()
    scale = min(net_w / img_w, net_h / img_h)
    nw, nh = img_w * scale, img_h * scale
    dx = (net_w - nw) / 2 / net_w
    dy = (net_h - nh) / 2 / net_h
    boxes[..., 0] = (boxes[..., 0] - dx) / (nw / net_w)
    boxes[..., 1] = (boxes[..., 1] - dy) / (nh / net_h)
    boxes[..., 2] = boxes[..., 2] / (nw / net_w)
    boxes[..., 3] = boxes[..., 3] / (nh / net_h)
    return boxes


def letterbox_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Aspect-preserving resize with 0.5-gray padding (upstream darknet's
    letterbox; offered as an option even though this reference fork does not
    letterbox at inference)."""
    ih, iw, c = im.shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = resize_image_cv(im, nw, nh)
    out = np.full((h, w, c), 0.5, dtype=np.float32)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    out[dy:dy + nh, dx:dx + nw, :] = resized
    return out


def make_letterbox_device(img_h: int, img_w: int, net_w: int, net_h: int,
                          channels: int = 3):
    """Jitted on-device batched letterbox: (N, img_h, img_w, C) uint8 BGR
    or RGB frames -> (N, net_h, net_w, C) float32 in [0,1], aspect
    preserved, 0.5-gray padding.

    The device-side analogue of `letterbox_image` for multi-camera
    streaming: moves the per-frame resize off the single host CPU (the
    multi-camera bottleneck) onto the accelerator; geometry matches
    `correct_boxes_letterbox`.  jax.image.resize('linear') uses half-pixel
    centers like cv2.INTER_LINEAR (values agree to interpolation
    tolerance, not bit-exactly).
    """
    import jax
    import jax.numpy as jnp

    scale = min(net_w / img_w, net_h / img_h)
    nw, nh = int(img_w * scale), int(img_h * scale)
    dy, dx = (net_h - nh) // 2, (net_w - nw) // 2

    @jax.jit
    def letterbox(frames):
        x = frames.astype(jnp.float32) / 255.0
        r = jax.image.resize(x, (x.shape[0], nh, nw, channels),
                             method="linear", antialias=False)
        return jnp.pad(
            r, ((0, 0), (dy, net_h - nh - dy), (dx, net_w - nw - dx),
                (0, 0)), constant_values=0.5)

    return letterbox
