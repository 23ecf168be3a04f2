"""YOLO v3/v4 training loss — the reference's delta computation as tensor ops.

The reference trains not via autodiff of a scalar loss but by filling a
`delta` array (gradient-ASCENT direction w.r.t. the head's activated output,
passed through unchanged to the head conv's raw output — BCE-with-logits
convention) with a triple-nested CPU loop (`yolo_layer.cpp:430-692`).  This
module reproduces those semantics exactly, on device:

* phase 1 (vectorized over B,H,W,A): objectness background deltas with the
  `ignore_thresh` / `truth_thresh` dual-threshold scheme
  (yolo_layer.cpp:486-515);
* phase 2 (vectorized over the (max_boxes, anchors) candidate lattice,
  with last-writer-wins priorities reproducing the reference's
  sequential write semantics): per-GT anchor assignment by
  max-IoU over shifted anchor priors plus `iou_thresh` extra matches
  (yolo_layer.cpp:543-672), box deltas via the MSE or IoU-family
  hand-gradient (delta_yolo_box:172-273, DxIou box.cpp:153-351 — including
  its quirks: beta ignored in the DIoU term, the simplified CIoU
  aspect-ratio gradient, `exp(raw)` chain for w/h only);
* phase 3 (vectorized): per-box delta averaging over matched classes
  (averages_yolo_deltas:275-293);
* cost assembly (yolo_layer.cpp:694-757): classification magnitude +
  averaged IoU loss.

Inputs are NHWC; truths are (B, max_boxes, 5) [x,y,w,h,class] with zero-x
terminating the valid prefix (the loader's packed layout, data.cpp:166-270).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp


from darknet_tpu.ops import boxes as boxops

_FLT_MAX = 3.402823466e38
_FLT_EPS = 1.19209290e-07


def _nan0(x):
    return jnp.where(jnp.isfinite(x), x, 0.0)


def dx_box_iou(pred, truth, kind: str):
    """Vectorized port of Box::DxIou (box.cpp:153-351).

    pred/truth: (..., 4) center-format.  Returns (dx, dy, dw, dh): the
    gradient of the IoU-family *value* w.r.t. pred's center coords —
    gradient-ascent direction on IoU.
    """
    px, py, pw, ph = pred[..., 0], pred[..., 1], pred[..., 2], pred[..., 3]
    gx, gy, gw, gh = truth[..., 0], truth[..., 1], truth[..., 2], truth[..., 3]

    # pred edges, min/max-normalized (negative w/h handled like the C)
    pt = jnp.minimum(py - ph / 2, py + ph / 2)
    pb = jnp.maximum(py - ph / 2, py + ph / 2)
    pl = jnp.minimum(px - pw / 2, px + pw / 2)
    pr = jnp.maximum(px - pw / 2, px + pw / 2)
    gt_t, gt_b = gy - gh / 2, gy + gh / 2
    gt_l, gt_r = gx - gw / 2, gx + gw / 2

    X = (pb - pt) * (pr - pl)
    Xhat = (gt_b - gt_t) * (gt_r - gt_l)
    Ih = jnp.minimum(pb, gt_b) - jnp.maximum(pt, gt_t)
    Iw = jnp.minimum(pr, gt_r) - jnp.maximum(pl, gt_l)
    I = Iw * Ih
    U = X + Xhat - I
    S = jnp.square(px - gx) + jnp.square(py - gy)
    giou_Cw = jnp.maximum(pr, gt_r) - jnp.minimum(pl, gt_l)
    giou_Ch = jnp.maximum(pb, gt_b) - jnp.minimum(pt, gt_t)
    giou_C = giou_Cw * giou_Ch

    dX_t, dX_b = -(pr - pl), (pr - pl)
    dX_l, dX_r = -(pb - pt), (pb - pt)
    dI_t = jnp.where(pt > gt_t, -Iw, 0.0)
    dI_b = jnp.where(pb < gt_b, Iw, 0.0)
    dI_l = jnp.where(pl > gt_l, -Ih, 0.0)
    dI_r = jnp.where(pr < gt_r, Ih, 0.0)
    dU_t, dU_b = dX_t - dI_t, dX_b - dI_b
    dU_l, dU_r = dX_l - dI_l, dX_r - dI_r
    dC_t = jnp.where(pt < gt_t, -giou_Cw, 0.0)
    dC_b = jnp.where(pb > gt_b, giou_Cw, 0.0)
    dC_l = jnp.where(pl < gt_l, -giou_Ch, 0.0)
    dC_r = jnp.where(pr > gt_r, giou_Ch, 0.0)

    Upos = U > 0
    U2 = jnp.where(Upos, U * U, 1.0)
    p_dt = jnp.where(Upos, (U * dI_t - I * dU_t) / U2, 0.0)
    p_db = jnp.where(Upos, (U * dI_b - I * dU_b) / U2, 0.0)
    p_dl = jnp.where(Upos, (U * dI_l - I * dU_l) / U2, 0.0)
    p_dr = jnp.where(Upos, (U * dI_r - I * dU_r) / U2, 0.0)
    # corner swap for inverted boxes (box.cpp:209-212); note the C swaps
    # t with the ALREADY-swapped b (its p_db line reads the new p_dt), which
    # for the top<bottom false case yields p_db==p_dt==old p_db; replicate.
    swap_tb = jnp.logical_not((py - ph / 2) < (py + ph / 2))
    swap_lr = jnp.logical_not((px - pw / 2) < (px + pw / 2))
    p_dt2 = jnp.where(swap_tb, p_db, p_dt)
    p_db2 = jnp.where(swap_tb, p_db, p_db)   # C quirk: reads updated p_dt
    p_dl2 = jnp.where(swap_lr, p_dr, p_dl)
    p_dr2 = jnp.where(swap_lr, p_dr, p_dr)
    p_dt, p_db, p_dl, p_dr = p_dt2, p_db2, p_dl2, p_dr2

    no_inter = (Iw <= 0) | (Ih <= 0)
    if kind == "giou":
        Cpos = giou_C > 0
        C2 = jnp.where(Cpos, giou_C * giou_C, 1.0)
        g_t = jnp.where(Cpos, (giou_C * dU_t - U * dC_t) / C2, 0.0)
        g_b = jnp.where(Cpos, (giou_C * dU_b - U * dC_b) / C2, 0.0)
        g_l = jnp.where(Cpos, (giou_C * dU_l - U * dC_l) / C2, 0.0)
        g_r = jnp.where(Cpos, (giou_C * dU_r - U * dC_r) / C2, 0.0)
        p_dt = jnp.where(no_inter, g_t, p_dt + g_t)
        p_db = jnp.where(no_inter, g_b, p_db + g_b)
        p_dl = jnp.where(no_inter, g_l, p_dl + g_l)
        p_dr = jnp.where(no_inter, g_r, p_dr + g_r)

    # map edge-gradients to center-format (box.cpp:275-283)
    p_dx = p_dl + p_dr
    p_dy = p_dt + p_db
    p_dw = p_dr - p_dl
    p_dh = p_db - p_dt

    if kind in ("diou", "ciou"):
        Ct = jnp.minimum(py - ph / 2, gy - gh / 2)
        Cb = jnp.maximum(py + ph / 2, gy + gh / 2)
        Cl = jnp.minimum(px - pw / 2, gx - gw / 2)
        Cr = jnp.maximum(px + pw / 2, gx + gw / 2)
        Cw, Ch = Cr - Cl, Cb - Ct
        C = jnp.square(Cw) + jnp.square(Ch)

        dCt_dy = jnp.where(pt < gt_t, 1.0, 0.0)
        dCt_dh = jnp.where(pt < gt_t, -0.5, 0.0)
        dCb_dy = jnp.where(pb > gt_b, 1.0, 0.0)
        dCb_dh = jnp.where(pb > gt_b, 0.5, 0.0)
        dCl_dx = jnp.where(pl < gt_l, 1.0, 0.0)
        dCl_dw = jnp.where(pl < gt_l, -0.5, 0.0)
        dCr_dx = jnp.where(pr > gt_r, 1.0, 0.0)
        dCr_dw = jnp.where(pr > gt_r, 0.5, 0.0)

        dCw_dx, dCw_dw = dCr_dx - dCl_dx, dCr_dw - dCl_dw
        dCh_dy, dCh_dh = dCb_dy - dCt_dy, dCb_dh - dCt_dh

        Cpos = C > 0
        C2 = jnp.where(Cpos, jnp.square(C), 1.0)
        # note: the hand gradient is for beta=1 regardless of beta_nms
        d_dx = (2 * (gx - px) * C - (2 * Cw * dCw_dx) * S) / C2
        d_dy = (2 * (gy - py) * C - (2 * Ch * dCh_dy) * S) / C2
        d_dw = (2 * Cw * dCw_dw) * S / C2
        d_dh = (2 * Ch * dCh_dh) * S / C2

        if kind == "ciou":
            ar_gt = gw / gh
            ar_pred = pw / ph
            inv_pi2 = 4.0 / (math.pi ** 2)
            d_atan = jnp.arctan(ar_gt) - jnp.arctan(ar_pred)
            ar_loss = inv_pi2 * jnp.square(d_atan)
            alpha = ar_loss / (1 - I / U + ar_loss + 1e-6)
            # simplified gradient as released by the CIoU authors
            ar_dw = 2 * inv_pi2 * d_atan * ph
            ar_dh = -2 * inv_pi2 * d_atan * pw
            d_dw = d_dw + alpha * ar_dw
            d_dh = d_dh + alpha * ar_dh

        p_dx = jnp.where(Cpos & no_inter, d_dx,
                         jnp.where(Cpos, p_dx + d_dx, p_dx))
        p_dy = jnp.where(Cpos & no_inter, d_dy,
                         jnp.where(Cpos, p_dy + d_dy, p_dy))
        p_dw = jnp.where(Cpos & no_inter, d_dw,
                         jnp.where(Cpos, p_dw + d_dw, p_dw))
        p_dh = jnp.where(Cpos & no_inter, d_dh,
                         jnp.where(Cpos, p_dh + d_dh, p_dh))

    return p_dx, p_dy, p_dw, p_dh


def _box_delta_terms(truth, pred, raw_wh, act_xy, cell_ij, l, net_w, net_h,
                     anchor_idx, scale, normalizer):
    """delta_yolo_box (yolo_layer.cpp:172-273), vectorized over any leading
    dims.  truth/pred: (...,4); raw_wh/act_xy: (...,2); cell_ij: (i, j)
    float arrays; anchor_idx: int array into l.anchors.
    Returns ((dx,dy,dw,dh), ious dict) with all entries shaped (...)."""
    i, j = cell_ij
    anchors = jnp.asarray(l.anchors, dtype=jnp.float32).reshape(-1, 2)
    aw = anchors[anchor_idx, 0]
    ah = anchors[anchor_idx, 1]

    ious = {
        "iou": boxops.iou(pred, truth),
        "giou": boxops.giou(pred, truth),
        "diou": boxops.diou(pred, truth, 0.6),
        "ciou": boxops.ciou(pred, truth),
    }
    # avoid nan in dx_box_iou (yolo_layer.cpp:184-191)
    pw = jnp.where(pred[..., 2] == 0, 1.0, pred[..., 2])
    ph = jnp.where(pred[..., 3] == 0, 1.0, pred[..., 3])
    pred = jnp.stack([pred[..., 0], pred[..., 1], pw, ph], axis=-1)

    if l.iou_loss == "mse":
        tx = truth[..., 0] * l.out_w - i
        ty = truth[..., 1] * l.out_h - j
        tw = jnp.log(truth[..., 2] * net_w / aw)
        th = jnp.log(truth[..., 3] * net_h / ah)
        dx = scale * (tx - act_xy[..., 0]) * normalizer
        dy = scale * (ty - act_xy[..., 1]) * normalizer
        dw = scale * (tw - raw_wh[..., 0]) * normalizer
        dh = scale * (th - raw_wh[..., 1]) * normalizer
    else:
        gx, gy, gw, gh = dx_box_iou(pred, truth, l.iou_loss)
        dx = _nan0(gx * normalizer)
        dy = _nan0(gy * normalizer)
        dw = _nan0(gw * jnp.exp(raw_wh[..., 0]) * normalizer)
        dh = _nan0(gh * jnp.exp(raw_wh[..., 1]) * normalizer)
        if l.max_delta != float("inf"):
            md = l.max_delta
            dx = jnp.clip(dx, -md, md)
            dy = jnp.clip(dy, -md, md)
            dw = jnp.clip(dw, -md, md)
            dh = jnp.clip(dh, -md, md)
    return (dx, dy, dw, dh), ious


def _nan0_keep(new, old):
    """result_delta written only when finite (delta_yolo_class NaN guard)."""
    return jnp.where(jnp.isfinite(new), new, old)


def yolo_head_delta(raw, truths, l, net_w: int, net_h: int):
    """Compute the training delta for one [yolo] head.

    raw:    (B, H, W, A*E) raw head conv output (pre-activation), f32
    truths: (B, max_boxes, 5) [x, y, w, h, class_id]
    Returns (delta (B,H,W,A*E) — gradient-ASCENT direction w.r.t. raw —
    cost scalar, metrics dict).
    """
    e = 4 + 1 + l.classes
    b, h, w, _ = raw.shape
    A = l.n
    v_raw = raw.reshape(b, h, w, A, e)

    # inference activations (yolo_activate semantics), computed on the
    # RAW (B,H,W,A*E) channel layout, with a channel mask selecting
    # which entries activate (one elementwise pass, no (...,A,E)
    # relayout)
    ch = np.arange(A * e) % e
    m_sig = jnp.asarray((ch < 2) | (ch >= 4))
    s = jax.nn.sigmoid(raw)
    v255 = jnp.where(m_sig, s, raw)
    if l.scale_x_y != 1.0:
        m_xy = jnp.asarray(ch < 2)
        v255 = jnp.where(
            m_xy, v255 * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0), v255)
    v = v255.reshape(b, h, w, A, e)

    def per_item(v_i, vr_i, truth_i):
        return _yolo_delta_single(v_i, vr_i, truth_i, l, net_w, net_h)

    delta, counters = jax.vmap(per_item)(v, v_raw, truths)
    # counters: dict of (B,) — sum over batch
    tot = {k: jnp.sum(x) for k, x in counters.items()}

    count = jnp.maximum(tot["count"], 1.0)
    class_count = jnp.maximum(tot["class_count"], 1.0)

    delta_flat = delta.reshape(b, h, w, A * e)
    # cost (yolo_layer.cpp:705-757)
    # sum of squares with box channels excluded — slice+reduce instead of
    # zeroing a copy of the full (B,H,W,A,E) tensor (the update-slice was
    # 6.3 ms of a 214 ms yolov4-608 b16 step, trace-measured)
    classification_loss = l.cls_normalizer * jnp.sum(
        jnp.square(delta[..., 4:]))
    full_loss = jnp.sum(jnp.square(delta))
    iou_loss_mag = full_loss - classification_loss
    if l.iou_loss == "mse":
        cost = full_loss
    else:
        if l.iou_loss == "giou":
            avg_iou_loss = l.iou_normalizer * (tot["giou_loss"] / count)
        else:
            avg_iou_loss = l.iou_normalizer * (tot["iou_loss"] / count)
        cost = avg_iou_loss + classification_loss

    metrics = {
        "avg_iou": tot["iou"] / count,
        "avg_obj": tot["obj"] / count,
        "avg_anyobj": tot["anyobj"] / (h * w * A * b),
        "avg_cat": tot["cat"] / class_count,
        "recall50": tot["recall50"] / count,
        "recall75": tot["recall75"] / count,
        "count": tot["count"],
        "loss": full_loss / b,
        "class_loss": classification_loss / b,
        "iou_loss": iou_loss_mag / b,
    }
    return delta_flat, cost, metrics


def _yolo_delta_single(v, v_raw, truth, l, net_w, net_h):
    """Delta for one batch item.  v/v_raw: (H,W,A,E); truth: (T,5).

    Internally flattened to (N=H*W*A, E) with the background-IoU lattice
    in (T, N) layout: the long N axis is the minor (contiguous) one,
    where an (H,W,A,T) layout would put the short A and T axes there.
    Cell/anchor
    constants (grid coords, per-position anchor dims) are baked as numpy
    arrays — no device gathers for static data."""
    h, w, A, e = v.shape
    N = h * w * A
    T = truth.shape[0]
    classes = l.classes
    total = l.total
    anchors_np = np.asarray(l.anchors, np.float32).reshape(-1, 2)
    cls_mults = (jnp.asarray(l.classes_multipliers, dtype=jnp.float32)
                 if l.classes_multipliers is not None else None)

    vf = v.reshape(N, e)            # contiguous reshapes: layout no-ops
    vrf = v_raw.reshape(N, e)

    # static per-cell constants: N index = (j*W + i)*A + a
    n_idx = np.arange(N)
    a_of = n_idx % A
    mask_np = np.asarray(l.mask, np.int64)
    cols = jnp.asarray(((n_idx // A) % w).astype(np.float32))
    rows = jnp.asarray((n_idx // (A * w)).astype(np.float32))
    awN = jnp.asarray(anchors_np[mask_np, 0][a_of])
    ahN = jnp.asarray(anchors_np[mask_np, 1][a_of])

    tx, tcls_f = truth[:, 0:4], truth[:, 4]
    tcls = tcls_f.astype(jnp.int32)
    # valid prefix: stops at first x==0 (break); invalid class ids skipped
    nonzero = tx[:, 0] != 0.0
    prefix = jnp.cumprod(nonzero.astype(jnp.int32)) == 1
    cls_ok = (tcls >= 0) & (tcls < classes)
    valid = prefix & cls_ok
    if l.class_map is not None:
        # cfg `map=`: remap truth ids for the class/multiplier deltas only
        # (validity checks use the raw id, yolo_layer.cpp:497)
        tcls = jnp.asarray(l.class_map, jnp.int32)[
            jnp.clip(tcls, 0, len(l.class_map) - 1)]

    # decode (GetYoloBox) as coordinate planes (N,)
    px = (cols + vf[:, 0]) / w
    py = (rows + vf[:, 1]) / h
    pw = jnp.exp(vrf[:, 2]) * awN / net_w
    ph = jnp.exp(vrf[:, 3]) * ahN / net_h
    obj = _nan0(vf[:, 4])                                    # NaN scrub :468
    cls_prob = vf[:, 5:]                                     # (N,C)

    # ---------------- phase 1: background objectness --------------------
    # IoU of every cell box vs every truth, (T, N) — ops mirror
    # boxes.iou exactly (same primitives, same order: bit-identical)
    pl = px - pw / 2
    pr = px + pw / 2
    pt = py - ph / 2
    pb = py + ph / 2
    txx, tyy = tx[:, 0:1], tx[:, 1:2]                        # (T,1)
    tww, thh = tx[:, 2:3], tx[:, 3:4]
    iw = jnp.minimum(pr[None, :], txx + tww / 2) - \
        jnp.maximum(pl[None, :], txx - tww / 2)
    ih = jnp.minimum(pb[None, :], tyy + thh / 2) - \
        jnp.maximum(pt[None, :], tyy - thh / 2)
    inter = jnp.where((iw < 0) | (ih < 0), 0.0, iw * ih)     # (T,N)
    un = (pw * ph)[None, :] + tww * thh - inter
    safe = (jnp.abs(inter) >= _FLT_EPS) & (jnp.abs(un) >= _FLT_EPS)
    iou_all = jnp.where(safe, inter / jnp.where(safe, un, 1.0), 0.0)
    iou_all = jnp.where(valid[:, None], iou_all, -1.0)
    best_iou = jnp.max(iou_all, axis=0)                      # (N,)
    best_t = jnp.argmax(iou_all, axis=0)
    best_iou = jnp.maximum(best_iou, 0.0)
    any_cls = jnp.any(cls_prob > 0.25, axis=-1)              # (N,)
    best_match_iou = jnp.where(any_cls, best_iou, 0.0)

    d_obj = l.cls_normalizer * (0.0 - obj)
    d_obj = jnp.where(best_match_iou > l.ignore_thresh, 0.0, d_obj)

    d_box = jnp.zeros((N, 4), jnp.float32)
    d_cls = jnp.zeros((N, classes), jnp.float32)

    counters = {k: jnp.zeros((), jnp.float32) for k in (
        "count", "class_count", "iou", "giou", "iou_loss", "giou_loss",
        "obj", "cat", "recall50", "recall75")}
    counters["anyobj"] = jnp.sum(obj)

    # truth_thresh branch (off by default: truth_thresh=1)
    if l.truth_thresh < 1.0:
        hit = best_iou > l.truth_thresh
        d_obj = jnp.where(hit, l.cls_normalizer * (1.0 - obj), d_obj)
        bt_cls = jnp.take(tcls, best_t)                      # (N,)
        bt_box = tx[best_t]                                  # (N,4)
        cmul = cls_mults[bt_cls] if cls_mults is not None else \
            jnp.ones_like(best_iou)
        # class delta (vectorized, no already-set ordering inside phase 1)
        onehot = jax.nn.one_hot(bt_cls, classes, dtype=jnp.float32)
        eps = l.label_smooth_eps
        y_true = onehot * (1 - eps) + 0.5 * eps if eps else onehot
        full = y_true - cls_prob
        if cls_mults is not None:
            full = jnp.where(onehot > 0, full * cmul[..., None], full)
        d_cls = jnp.where(hit[..., None], full, d_cls)
        # box delta
        scale = 2.0 - bt_box[..., 2] * bt_box[..., 3]
        normz = l.iou_normalizer * cmul
        pred_nk = jnp.stack([px, py, pw, ph], axis=-1)       # (N,4)
        (ddx, ddy, ddw, ddh), _ = _box_delta_terms(
            bt_box, pred_nk, vrf[:, 2:4], vf[:, 0:2], (cols, rows),
            l, net_w, net_h, jnp.asarray(mask_np[a_of]), scale, normz)
        add = jnp.stack([ddx, ddy, ddw, ddh], axis=-1)
        d_box = d_box + jnp.where(hit[..., None], add, 0.0)

    # ---------------- phase 2: per-truth assignment ---------------------
    # Fully vectorized over the (T, total) candidate lattice — no
    # sequential loop.  The reference's loop order (t outer, n inner)
    # only matters for the "set"-type writes (objectness, class), whose
    # values are writer-independent except via classes_multipliers; we
    # resolve collisions with an explicit last-writer-wins priority
    # (t*total+n), reproducing the C semantics without serial scatters
    # (each a separate dependent device step).
    prior = jnp.concatenate(
        [jnp.zeros((total, 2), jnp.float32), jnp.asarray(
            anchors_np / np.asarray([net_w, net_h], np.float32))],
        axis=1)                                              # (total,4)

    mask_pos = np.full((total,), -1, np.int64)
    for mi, mv in enumerate(l.mask):
        mask_pos[mv] = mi
    mask_pos = jnp.asarray(mask_pos, jnp.int32)              # (total,)

    ti = jnp.clip((tx[:, 0] * w).astype(jnp.int32), 0, w - 1)   # (T,)
    tj = jnp.clip((tx[:, 1] * h).astype(jnp.int32), 0, h - 1)
    truth_shift = jnp.concatenate(
        [jnp.zeros((T, 2), jnp.float32), tx[:, 2:4]], axis=1)   # (T,4)
    prior_iou = boxops.iou(prior[None, :, :], truth_shift[:, None, :])
    best_n = jnp.argmax(prior_iou, axis=1).astype(jnp.int32)    # (T,)

    is_best = jnp.arange(total)[None, :] == best_n[:, None]     # (T,total)
    in_mask = (mask_pos >= 0)[None, :]
    if l.iou_thresh < 1.0:
        kind_iou = boxops.iou_kind(prior[None, :, :],
                                   truth_shift[:, None, :], l.iou_thresh_kind)
        extra = (~is_best) & (kind_iou > l.iou_thresh)
    else:
        extra = jnp.zeros_like(is_best)
    apply = valid[:, None] & in_mask & (is_best | extra)        # (T,total)
    fapply = apply.astype(jnp.float32)

    a_idx = jnp.maximum(mask_pos, 0)[None, :] * jnp.ones(
        (T, 1), jnp.int32)                                      # (T,total)
    tj2 = tj[:, None] * jnp.ones((1, total), jnp.int32)
    ti2 = ti[:, None] * jnp.ones((1, total), jnp.int32)

    # per-candidate cell state: ONE row-gather from the flat (N, ...)
    # state instead of five (H,W,A,·) advanced-indexing gathers
    cell = (tj2 * w + ti2) * A + a_idx                          # (T,total)
    cell_flat = cell.reshape(-1)                                # (TT,)
    state = jnp.concatenate(
        [jnp.stack([px, py, pw, ph], axis=-1),                  # 0:4 pred
         vrf[:, 2:4],                                           # 4:6 raw wh
         vf[:, 0:2],                                            # 6:8 act xy
         obj[:, None]], axis=-1)                                # 8   obj
    st_c = state[cell_flat].reshape(T, total, 9)
    pred_c = st_c[..., 0:4]                                     # (T,total,4)
    raw_wh_c = st_c[..., 4:6]
    act_xy_c = st_c[..., 6:8]
    obj_c = st_c[..., 8]                                        # (T,total)
    cid2 = jnp.broadcast_to(tcls[:, None], (T, total))
    cls_p_c = cls_prob[cell_flat].reshape(T, total, classes)

    cmul_t = (cls_mults[tcls] if cls_mults is not None
              else jnp.ones((T,), jnp.float32))                 # (T,)
    scale_t = 2.0 - tx[:, 2] * tx[:, 3]
    anchor_n = jnp.broadcast_to(jnp.arange(total, dtype=jnp.int32)[None, :],
                                (T, total))

    (ddx, ddy, ddw, ddh), ious = _box_delta_terms(
        jnp.broadcast_to(tx[:, None, :], (T, total, 4)), pred_c,
        raw_wh_c, act_xy_c,
        (ti2.astype(jnp.float32), tj2.astype(jnp.float32)),
        l, net_w, net_h, anchor_n, scale_t[:, None],
        (l.iou_normalizer * cmul_t)[:, None])
    box_add = jnp.stack([ddx, ddy, ddw, ddh], axis=-1)          # (T,total,4)

    # scatter-add box deltas (commutative, order-free)
    flat_add = jnp.where(apply[..., None], box_add, 0.0).reshape(-1, 4)
    d_box = d_box + jax.ops.segment_sum(
        flat_add, cell_flat, num_segments=N)                    # (N,4)

    # objectness / class: last-writer-wins per cell (C iteration order)
    prio = (jnp.arange(T)[:, None] * total +
            jnp.arange(total)[None, :] + 1)                     # 1-based
    prio = jnp.where(apply, prio, 0).reshape(-1)
    win_prio = jax.ops.segment_max(prio, cell_flat,
                                   num_segments=N)
    cell_hit = win_prio > 0                                     # (N,)
    win_idx = jnp.clip(win_prio - 1, 0, T * total - 1)          # (N,)
    win_t = win_idx // total
    win_cmul = cmul_t[win_t]                                    # (N,)
    win_cid = tcls[win_t]

    new_obj = win_cmul * l.cls_normalizer * (1.0 - obj)
    d_obj = jnp.where(cell_hit, new_obj, d_obj)

    # class deltas: entry c set to (y1 - p_c)[*mult_c] when some candidate
    # with class c hits the cell; other entries (y0 - p_c) when the cell is
    # hit at all (delta_yolo_class full-set + already-set semantics)
    class_onehot = jax.nn.one_hot(cid2, classes, dtype=jnp.float32)
    class_hit_flat = jax.ops.segment_sum(
        jnp.where(apply[..., None], class_onehot, 0.0).reshape(-1, classes),
        cell_flat, num_segments=N)
    class_hit = class_hit_flat > 0                               # (N,C)

    eps_s = l.label_smooth_eps
    y1 = 1.0 * (1 - eps_s) + 0.5 * eps_s if eps_s else 1.0
    y0 = 0.5 * eps_s if eps_s else 0.0
    if l.focal_loss:
        # focal: full overwrite by the winning candidate's class
        alpha = 0.5
        oh_win = jax.nn.one_hot(win_cid, classes, dtype=jnp.float32)
        pt = jnp.take_along_axis(cls_prob, win_cid[..., None],
                                 axis=-1)[..., 0] + 1e-15
        grad = -(1 - pt) * (2 * pt * jnp.log(pt) + pt - 1)
        focal_vec = (oh_win - cls_prob) * (alpha * grad)[..., None]
        d_cls = jnp.where(cell_hit[..., None], focal_vec, d_cls)
    else:
        mult_vec = (cls_mults[None, :]
                    if cls_mults is not None else 1.0)
        tgt = _nan0_keep((y1 - cls_prob), d_cls) * mult_vec
        rest = _nan0_keep((y0 - cls_prob), d_cls)
        d_cls = jnp.where(class_hit, tgt,
                          jnp.where(cell_hit[..., None], rest, d_cls))

    # counters (masked sums over candidates)
    counters["count"] = counters["count"] + jnp.sum(fapply)
    counters["class_count"] = counters["class_count"] + jnp.sum(fapply)
    counters["iou"] = counters["iou"] + jnp.sum(fapply * ious["iou"])
    counters["giou"] = counters["giou"] + jnp.sum(fapply * ious["giou"])
    counters["iou_loss"] = counters["iou_loss"] + \
        jnp.sum(fapply * (1.0 - ious["iou"]))
    counters["giou_loss"] = counters["giou_loss"] + \
        jnp.sum(fapply * (1.0 - ious["giou"]))
    counters["obj"] = counters["obj"] + jnp.sum(fapply * obj_c)
    cat_c = jnp.take_along_axis(cls_p_c, cid2[..., None], axis=-1)[..., 0]
    counters["cat"] = counters["cat"] + jnp.sum(fapply * cat_c)
    counters["recall50"] = counters["recall50"] + \
        jnp.sum(fapply * (ious["iou"] > 0.5))
    counters["recall75"] = counters["recall75"] + \
        jnp.sum(fapply * (ious["iou"] > 0.75))

    # ---------------- phase 3: class-count averaging --------------------
    n_cls_hit = jnp.sum((d_cls > 0).astype(jnp.float32), axis=-1,
                        keepdims=True)                       # (N,1)
    d_box = jnp.where(n_cls_hit > 0, d_box / jnp.maximum(n_cls_hit, 1.0),
                      d_box)

    delta = jnp.concatenate(
        [d_box, d_obj[..., None], d_cls], axis=-1)           # (N,E)
    return delta.reshape(h, w, A, e), counters
