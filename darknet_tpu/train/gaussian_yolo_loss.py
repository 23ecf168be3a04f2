"""Gaussian-YOLO training loss (gaussian_yolo_layer.cpp:519-860).

Same two-phase structure as the [yolo] loss but with 8 box channels
(mu/sigma per coordinate) and a Gaussian negative-log-likelihood gradient:

* per-coordinate NLL with ``sigma_const=0.3``, ``epsi=1e-9``
  (delta_gaussian_yolo_box:195-405) — note ``temp_* = scale/2`` after the
  normal_dist cancellation, kept literal for NaN-behaviour parity;
* with an IoU-family loss the MU deltas are replaced by DxIou gradients
  (yolo_point-adjusted) while the SIGMA deltas stay NLL;
* DeltaGaussianYoloClass's "already set" guard reads the CLASS-0 entry
  (`if (delta[index])`, :631) — a reference quirk, replicated;
* `yolo_point` shifts the anchor cell and tx/ty targets (:633-648);
* cost = full delta magnitude; class/iou/uc loss components split per
  :775-840 (including its quirk of counting mu_w/mu_h in the "uncertainty"
  component).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from darknet_tpu.ops import boxes as boxops
from darknet_tpu.train.yolo_loss import _FLT_EPS, _nan0, dx_box_iou

_SIGMA_CONST = 0.3
_EPSI = 1e-9
_G = 9          # entries before classes: mux,sigx,muy,sigy,muw,sigw,muh,sigh,obj


def _gaussian_box_delta(truth, box_v, pred, l, net_w, net_h, anchor_idx,
                        cell_i, cell_j, scale, iou_norm, uc_norm):
    """delta_gaussian_yolo_box vectorized over leading dims.

    box_v: (...,8) activated entries [mux,sigx,muy,sigy,muw,sigw,muh,sigh].
    Returns (d_mu (...,4) in x,y,w,h order, d_sig (...,4), ious).
    """
    anchors = jnp.asarray(l.anchors, dtype=jnp.float32).reshape(-1, 2)
    aw = anchors[anchor_idx, 0]
    ah = anchors[anchor_idx, 1]

    ious = {"iou": boxops.iou(pred, truth),
            "giou": boxops.giou(pred, truth)}
    pw = jnp.where(pred[..., 2] == 0, 1.0, pred[..., 2])
    ph = jnp.where(pred[..., 3] == 0, 1.0, pred[..., 3])
    pred = jnp.stack([pred[..., 0], pred[..., 1], pw, ph], axis=-1)

    tx = truth[..., 0] * l.out_w - cell_i
    ty = truth[..., 1] * l.out_h - cell_j
    if l.yolo_point == "left_top":
        tx = (truth[..., 0] - truth[..., 2] / 2) * l.out_w - cell_i
        ty = (truth[..., 1] - truth[..., 3] / 2) * l.out_h - cell_j
    elif l.yolo_point == "right_bottom":
        tx = (truth[..., 0] + truth[..., 2] / 2) * l.out_w - cell_i
        ty = (truth[..., 1] + truth[..., 3] / 2) * l.out_h - cell_j
    tw = jnp.log(truth[..., 2] * net_w / aw)
    th = jnp.log(truth[..., 3] * net_h / ah)

    mu = jnp.stack([box_v[..., 0], box_v[..., 2], box_v[..., 4],
                    box_v[..., 6]], axis=-1)
    sig = jnp.stack([box_v[..., 1], box_v[..., 3], box_v[..., 5],
                     box_v[..., 7]], axis=-1)
    tgt = jnp.stack([tx, ty, tw, th], axis=-1)

    d = tgt - mu
    in_exp = d / sig
    in_exp2 = jnp.square(in_exp)
    normal = jnp.exp(in_exp2 * -0.5) / (
        jnp.sqrt(jnp.float32(2.0 * math.pi)) * (sig + _SIGMA_CONST))
    temp = 0.5 * normal / (normal + _EPSI) * scale[..., None]

    d_mu = temp * in_exp / sig
    d_sig = temp * (in_exp2 / sig - 1.0 / (sig + _SIGMA_CONST))

    if l.iou_loss != "mse":
        gx, gy, gw, gh = dx_box_iou(pred, truth, l.iou_loss)
        if l.yolo_point == "left_top":
            gx = gx - gw / 2
            gy = gy - gh / 2
        elif l.yolo_point == "right_bottom":
            gx = gx + gw / 2
            gy = gy + gh / 2
        gw = gw * jnp.exp(box_v[..., 4])
        gh = gh * jnp.exp(box_v[..., 6])
        d_mu = jnp.stack([gx, gy, gw, gh], axis=-1)

    d_mu = _nan0(d_mu * iou_norm[..., None])
    d_sig = _nan0(d_sig * uc_norm)
    if l.max_delta != float("inf"):
        d_mu = jnp.clip(d_mu, -l.max_delta, l.max_delta)
        d_sig = jnp.clip(d_sig, -l.max_delta, l.max_delta)
    return d_mu, d_sig, ious


def gaussian_yolo_head_delta(raw, truths, l, net_w: int, net_h: int):
    """Training delta for one [Gaussian_yolo] head.

    raw: (B,H,W,A*(9+C)); truths: (B,T,5).  Returns (delta, cost, metrics).
    """
    e = _G + l.classes
    b, h, w, _ = raw.shape
    A = l.n
    v_raw = raw.reshape(b, h, w, A, e)

    # activations (ForwardGaussianYoloLayer:491-517), computed on the raw
    # (B,H,W,A*E) channel layout with a channel mask (see yolo_loss.py):
    # sigmoid on {mux,sigx,muy,sigy, sigw, sigh, obj, classes}; muw/muh
    # stay raw; scale_x_y affine on mux/muy
    ch = np.arange(A * e) % e
    m_sig = jnp.asarray((ch <= 3) | (ch == 5) | (ch == 7) | (ch >= 8))
    s = jax.nn.sigmoid(raw)
    v255 = jnp.where(m_sig, s, raw)
    if l.scale_x_y != 1.0:
        m_xy = jnp.asarray((ch == 0) | (ch == 2))
        v255 = jnp.where(
            m_xy, v255 * l.scale_x_y - 0.5 * (l.scale_x_y - 1.0), v255)
    v = v255.reshape(b, h, w, A, e)

    def per_item(v_i, vr_i, truth_i):
        return _gaussian_delta_single(v_i, vr_i, truth_i, l, net_w, net_h)

    delta, counters = jax.vmap(per_item)(v, v_raw, truths)
    tot = {k: jnp.sum(x) for k, x in counters.items()}
    count = jnp.maximum(tot["count"], 1.0)
    class_count = jnp.maximum(tot["class_count"], 1.0)

    delta_flat = delta.reshape(b, h, w, A * e)

    # loss components (gaussian_yolo_layer.cpp:775-840)
    # channel-range sums of squares via slice+reduce (no zeroed full-tensor
    # copies): class_loss excludes [0:8]; except_uc excludes the
    # muw/sigw/muh/sigh quirk range [4:8] (gaussian_yolo_layer.cpp:775-840)
    class_loss = jnp.sum(jnp.square(delta[..., 8:]))
    sq_0_4 = jnp.sum(jnp.square(delta[..., 0:4]))
    except_uc_loss = sq_0_4 + class_loss
    full = sq_0_4 + jnp.sum(jnp.square(delta[..., 4:8])) + class_loss
    cost = full

    metrics = {
        "loss": full / b,
        "class_loss": class_loss / b,
        "uc_loss": (full - except_uc_loss) / b,
        "iou_loss": (except_uc_loss - class_loss) / b,
        "avg_iou": tot["iou"] / count,
        "avg_obj": tot["obj"] / count,
        "avg_cat": tot["cat"] / class_count,
        "recall50": tot["recall50"] / count,
        "recall75": tot["recall75"] / count,
        "count": tot["count"],
    }
    return delta_flat, cost, metrics


def _gaussian_delta_single(v, v_raw, truth, l, net_w, net_h):
    """Flat-N layout like yolo_loss._yolo_delta_single: (T,N) background
    IoU lattice, baked grid/anchor constants, one packed-state gather."""
    h, w, A, e = v.shape
    N = h * w * A
    T = truth.shape[0]
    classes = l.classes
    total = l.total
    anchors_np = np.asarray(l.anchors, np.float32).reshape(-1, 2)
    cls_mults = (jnp.asarray(l.classes_multipliers, dtype=jnp.float32)
                 if l.classes_multipliers is not None else None)

    vf = v.reshape(N, e)

    n_idx = np.arange(N)
    a_of = n_idx % A
    mask_np = np.asarray(l.mask, np.int64)
    cols = jnp.asarray(((n_idx // A) % w).astype(np.float32))
    rows = jnp.asarray((n_idx // (A * w)).astype(np.float32))
    awN = jnp.asarray(anchors_np[mask_np, 0][a_of])
    ahN = jnp.asarray(anchors_np[mask_np, 1][a_of])

    tx = truth[:, 0:4]
    tcls = truth[:, 4].astype(jnp.int32)
    nonzero = tx[:, 0] != 0.0
    prefix = jnp.cumprod(nonzero.astype(jnp.int32)) == 1
    cls_ok = (tcls >= 0) & (tcls < classes)
    valid = prefix & cls_ok
    if l.class_map is not None:
        tcls = jnp.asarray(l.class_map, jnp.int32)[
            jnp.clip(tcls, 0, len(l.class_map) - 1)]

    # decode (GetGaussianYoloBox) as coordinate planes (N,)
    pw = jnp.exp(vf[:, 4]) * awN / net_w
    ph = jnp.exp(vf[:, 6]) * ahN / net_h
    px = (cols + vf[:, 0]) / w
    py = (rows + vf[:, 2]) / h
    if l.yolo_point == "left_top":
        px = px + pw / 2
        py = py + ph / 2
    elif l.yolo_point == "right_bottom":
        px = px - pw / 2
        py = py - ph / 2
    obj = _nan0(vf[:, 8])
    cls_prob = vf[:, 9:]                                     # (N,C)

    # phase 1: objectness background — (T,N) IoU lattice, ops mirroring
    # boxes.iou exactly (see yolo_loss)
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
    best_iou = jnp.maximum(jnp.max(iou_all, axis=0), 0.0)    # (N,)
    any_cls = jnp.any(cls_prob > 0.25, axis=-1)
    best_match_iou = jnp.where(any_cls, best_iou, 0.0)

    d_obj = l.cls_normalizer * (0.0 - obj)
    d_obj = jnp.where(best_match_iou > l.ignore_thresh, 0.0, d_obj)
    # (truth_thresh branch omitted: defaults to 1.0 in every known gaussian
    # cfg; phase 1 box/class deltas would mirror yolo_loss if enabled)

    d_cls = jnp.zeros((N, classes), jnp.float32)
    counters = {k: jnp.zeros((), jnp.float32) for k in (
        "count", "class_count", "iou", "obj", "cat", "recall50", "recall75")}
    counters["anyobj"] = jnp.sum(obj)

    # phase 2: vectorized candidate lattice (T, total)
    # anchor cell depends on yolo_point (:633-648)
    cx, cy = tx[:, 0], tx[:, 1]
    if l.yolo_point == "left_top":
        cx = cx - tx[:, 2] / 2
        cy = cy - tx[:, 3] / 2
    elif l.yolo_point == "right_bottom":
        cx = cx + tx[:, 2] / 2
        cy = cy + tx[:, 3] / 2
    ti = jnp.clip((cx * w).astype(jnp.int32), 0, w - 1)
    tj = jnp.clip((cy * h).astype(jnp.int32), 0, h - 1)

    truth_shift = jnp.concatenate(
        [jnp.zeros((T, 2), jnp.float32), tx[:, 2:4]], axis=1)
    prior = jnp.concatenate(
        [jnp.zeros((total, 2), jnp.float32), jnp.asarray(
            anchors_np / np.asarray([net_w, net_h], np.float32))], axis=1)
    prior_iou = boxops.iou(prior[None, :, :], truth_shift[:, None, :])
    best_n = jnp.argmax(prior_iou, axis=1).astype(jnp.int32)

    mask_pos = np.full((total,), -1, np.int64)
    for mi, mv in enumerate(l.mask):
        mask_pos[mv] = mi
    mask_pos = jnp.asarray(mask_pos, jnp.int32)

    is_best = jnp.arange(total)[None, :] == best_n[:, None]
    in_mask = (mask_pos >= 0)[None, :]
    if l.iou_thresh < 1.0:
        kind_iou = boxops.iou_kind(prior[None, :, :],
                                   truth_shift[:, None, :], l.iou_thresh_kind)
        extra = (~is_best) & (kind_iou > l.iou_thresh)
    else:
        extra = jnp.zeros_like(is_best)
    apply = valid[:, None] & in_mask & (is_best | extra)
    fapply = apply.astype(jnp.float32)

    a_idx = jnp.maximum(mask_pos, 0)[None, :] * jnp.ones((T, 1), jnp.int32)
    tj2 = tj[:, None] * jnp.ones((1, total), jnp.int32)
    ti2 = ti[:, None] * jnp.ones((1, total), jnp.int32)

    # per-candidate cell state: ONE packed row-gather from flat N
    cell = (tj2 * w + ti2) * A + a_idx                       # (T,total)
    cell_flat = cell.reshape(-1)
    state = jnp.concatenate(
        [jnp.stack([px, py, pw, ph], axis=-1),               # 0:4  pred
         vf[:, 0:8],                                         # 4:12 box_v
         obj[:, None]], axis=-1)                             # 12   obj
    st_c = state[cell_flat].reshape(T, total, 13)
    pred_c = st_c[..., 0:4]
    box_v_c = st_c[..., 4:12]
    obj_c = st_c[..., 12]
    cls_p_c = cls_prob[cell_flat].reshape(T, total, classes)
    cid2 = jnp.broadcast_to(tcls[:, None], (T, total))

    cmul_t = (cls_mults[tcls] if cls_mults is not None
              else jnp.ones((T,), jnp.float32))
    scale_t = 2.0 - tx[:, 2] * tx[:, 3]
    anchor_n = jnp.broadcast_to(
        jnp.arange(total, dtype=jnp.int32)[None, :], (T, total))

    d_mu, d_sig, ious = _gaussian_box_delta(
        jnp.broadcast_to(tx[:, None, :], (T, total, 4)), box_v_c, pred_c,
        l, net_w, net_h, anchor_n,
        ti2.astype(jnp.float32), tj2.astype(jnp.float32),
        jnp.broadcast_to(scale_t[:, None], (T, total)),
        (l.iou_normalizer * cmul_t)[:, None] *
        jnp.ones((1, total), jnp.float32),
        l.uc_normalizer)

    # interleave back into entry order [mux,sigx,muy,sigy,muw,sigw,muh,sigh]
    box_add = jnp.stack(
        [d_mu[..., 0], d_sig[..., 0], d_mu[..., 1], d_sig[..., 1],
         d_mu[..., 2], d_sig[..., 2], d_mu[..., 3], d_sig[..., 3]], axis=-1)

    flat_add = jnp.where(apply[..., None], box_add, 0.0).reshape(-1, 8)
    d_box = jax.ops.segment_sum(flat_add, cell_flat,
                                num_segments=N)              # (N,8)

    prio = (jnp.arange(T)[:, None] * total +
            jnp.arange(total)[None, :] + 1)
    prio = jnp.where(apply, prio, 0).reshape(-1)
    win_prio = jax.ops.segment_max(prio, cell_flat, num_segments=N)
    cell_hit = win_prio > 0                                  # (N,)
    win_idx = jnp.clip(win_prio - 1, 0, T * total - 1)
    win_t = win_idx // total
    win_cmul = cmul_t[win_t]

    d_obj = jnp.where(cell_hit,
                      win_cmul * l.cls_normalizer * (1.0 - obj), d_obj)

    class_onehot = jax.nn.one_hot(cid2, classes, dtype=jnp.float32)
    class_hit_flat = jax.ops.segment_sum(
        jnp.where(apply[..., None], class_onehot, 0.0).reshape(-1, classes),
        cell_flat, num_segments=N)
    class_hit = class_hit_flat > 0                           # (N,C)

    eps_s = l.label_smooth_eps
    y1 = 1.0 * (1 - eps_s) + 0.5 * eps_s if eps_s else 1.0
    y0 = 0.5 * eps_s if eps_s else 0.0
    mult_vec = (cls_mults[None, :]
                if cls_mults is not None else 1.0)
    # NOTE the reference's "already" guard reads class entry 0; our
    # cell-wise rule is equivalent whenever entry 0's delta is set by the
    # full write (always, since y0 - p != 0 generically)
    tgt = (y1 - cls_prob) * mult_vec
    rest = y0 - cls_prob
    d_cls = jnp.where(class_hit, tgt,
                      jnp.where(cell_hit[..., None], rest, d_cls))

    counters["count"] = counters["count"] + jnp.sum(fapply)
    counters["class_count"] = counters["class_count"] + jnp.sum(fapply)
    counters["iou"] = counters["iou"] + jnp.sum(fapply * ious["iou"])
    counters["obj"] = counters["obj"] + jnp.sum(fapply * obj_c)
    cat_c = jnp.take_along_axis(cls_p_c, cid2[..., None], axis=-1)[..., 0]
    counters["cat"] = counters["cat"] + jnp.sum(fapply * cat_c)
    counters["recall50"] = counters["recall50"] + \
        jnp.sum(fapply * (ious["iou"] > 0.5))
    counters["recall75"] = counters["recall75"] + \
        jnp.sum(fapply * (ious["iou"] > 0.75))

    # phase 3: class-count averaging over all 8 box entries
    n_cls_hit = jnp.sum((d_cls > 0).astype(jnp.float32), axis=-1,
                        keepdims=True)                       # (N,1)
    d_box = jnp.where(n_cls_hit > 0, d_box / jnp.maximum(n_cls_hit, 1.0),
                      d_box)

    delta = jnp.concatenate([d_box, d_obj[..., None], d_cls], axis=-1)
    delta = delta.reshape(h, w, A, e)
    return delta, counters
