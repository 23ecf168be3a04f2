"""NMS: exact host reference semantics + an on-device masked variant.

Reference (`box.cpp:372-419` NmsSort): per class, sort detections by that
class's prob (descending, qsort), then greedily zero the prob of any
lower-ranked detection whose IoU (greedy) or DIoU (diounms, beta) with a
surviving one exceeds `thresh`.  Boxes themselves are never removed — only
class probs are zeroed; a detection dies when all its probs are zero.

The device variant keeps the same semantics with a fixed box budget but no
sort and no serial rank loop: the stable descending rank order is encoded
as a dense suppressor predicate (p_j > p_i) | (p_j == p_i & j < i) over the
shared similarity matrix, and the exact greedy kept-set is obtained by an
interval fixpoint (lo/hi bounds under a while_loop) that converges in the
suppression-chain depth.  Only final detections leave HBM.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from darknet_tpu.ops import boxes as boxops


# --------------------------------------------------------------------------
# Host (numpy) exact reference implementation
# --------------------------------------------------------------------------

def _np_iou(a, b):
    def edges(v):
        return (v[..., 0] - v[..., 2] / 2, v[..., 0] + v[..., 2] / 2,
                v[..., 1] - v[..., 3] / 2, v[..., 1] + v[..., 3] / 2)

    al, ar, at, ab = edges(a)
    bl, br, bt, bb = edges(b)
    w = np.minimum(ar, br) - np.maximum(al, bl)
    h = np.minimum(ab, bb) - np.maximum(at, bt)
    inter = np.where((w < 0) | (h < 0), 0.0, w * h)
    uni = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    eps = np.finfo(np.float32).eps
    out = np.zeros_like(inter)
    ok = (np.abs(inter) >= eps) & (np.abs(uni) >= eps)
    out[ok] = inter[ok] / uni[ok]
    return out


def _np_diou(a, b, beta):
    def edges(v):
        return (v[..., 0] - v[..., 2] / 2, v[..., 0] + v[..., 2] / 2,
                v[..., 1] - v[..., 3] / 2, v[..., 1] + v[..., 3] / 2)

    al, ar, at, ab = edges(a)
    bl, br, bt, bb = edges(b)
    w = np.maximum(ar, br) - np.minimum(al, bl)
    h = np.maximum(ab, bb) - np.minimum(at, bt)
    c = w * w + h * h
    i = _np_iou(a, b)
    d = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    eps = np.finfo(np.float32).eps
    out = i.copy()
    ok = np.abs(c) >= eps
    out[ok] = i[ok] - np.power(d[ok] / c[ok], beta)
    return out


def nms_numpy(boxes: np.ndarray, probs: np.ndarray, thresh: float,
              kind: str = "greedynms", beta: float = 0.6,
              allow_native: bool = True) -> np.ndarray:
    """Exact NmsSort: boxes (N,4), probs (N,C) -> suppressed probs (N,C).

    Dispatches to the native C++ kernel (darknet_tpu/_native) when available —
    identical semantics, ~100x faster for the mAP validator's thousands of
    candidates; falls back to pure numpy."""
    if allow_native:
        from darknet_tpu.utils.native import nms_native

        out = nms_native(boxes, probs, thresh, kind=kind, beta=beta)
        if out is not None:
            return out
    boxes = np.asarray(boxes, dtype=np.float32)
    probs = np.asarray(probs, dtype=np.float32).copy()
    n, c = probs.shape
    eps = np.finfo(np.float32).eps
    for k in range(c):
        order = np.argsort(-probs[:, k], kind="stable")
        for oi in range(n):
            i = order[oi]
            if abs(probs[i, k]) < eps:
                continue
            a = boxes[i]
            rest = order[oi + 1:]
            if rest.size == 0:
                continue
            if kind == "greedynms":
                sim = _np_iou(a[None, :], boxes[rest])
            else:
                sim = _np_diou(a[None, :], boxes[rest], beta)
            probs[rest[sim > thresh], k] = 0.0
    return probs


# --------------------------------------------------------------------------
# Device (jnp) fixed-size variant
# --------------------------------------------------------------------------

def nms_device(boxes, probs, thresh: float, kind: str = "greedynms",
               beta: float = 0.6, impl: str = "fused"):
    """Masked greedy NMS on device: boxes (N,4), probs (N,C) -> (N,C).

    Matches NmsSort up to tie-ordering: per class, detections are visited in
    descending-prob order and suppressed by any *surviving* higher-ranked
    detection with similarity > thresh.  Runs as C independent passes over a
    shared (N,N) similarity matrix (vmapped); N is static.

    greedy kept[i] = active[i] & no surviving higher-ranked j with
    sim>thresh.  Two adaptations of the serial greedy loop to a
    data-parallel device:

    1. No argsort/gather: rank_j < rank_i (stable descending sort) is
       exactly (p_j > p_i) | (p_j == p_i & j < i), broadcast against the
       SHARED similarity matrix — the per-class [order][:, order] gather
       was the dominant cost.
    2. No serial rank loop (N dependent scatter steps serialize the
       device): dependencies run strictly down ranks (a DAG), so
       the exact kept-set is squeezed between monotone bounds
       Lo' = f(Hi), Hi' = f(Lo) with f(K)[i] = active[i] & !∃j: K[j] &
       P[i,j].  Ranks with suppression-chain depth <= t are decided
       after t iterations; the loop converges in the chain depth
       (typically < 5, bounded by N).

    impl="fused" (default) derives the rank predicate INSIDE the loop
    body so only the (N,N) suppress matrix persists — the broadcast-and
    feeds straight into the any-reduce and fuses; a batched call holds
    O(B*N^2), not the O(B*C*N^2) of impl="dense" (~1.3 GB at the b256
    serving bench).  "dense" materializes (C,N,N) once outside the loop
    (kept for A/B).
    """
    if impl not in ("fused", "dense"):
        raise ValueError(f"nms_device impl must be 'fused' or 'dense', "
                         f"got {impl!r}")
    n = boxes.shape[0]
    if kind == "greedynms":
        sim = boxops.iou(boxes[:, None, :], boxes[None, :, :])
    else:
        sim = boxops.diou(boxes[:, None, :], boxes[None, :, :], beta)
    suppress = sim > thresh

    pT = probs.T                                     # (C, N)
    lt = jnp.tril(jnp.ones((n, n), dtype=bool), -1)  # [i, j]: j < i
    active = pT > 0.0

    if impl == "dense":
        gt = pT[:, None, :] > pT[:, :, None]         # [c,i,j]: p_j > p_i
        eq = (pT[:, None, :] == pT[:, :, None]) & lt[None]
        P = (gt | eq) & suppress[None]               # suppressor j over i

        def step(K):
            return active & ~jnp.any(P & K[:, None, :], axis=-1)
    else:
        def step(K):
            # [c,i,j]: surviving j, higher-ranked than i, suppressing i —
            # derived in-body from (C,N) + (N,N) operands so the (C,N,N)
            # broadcast fuses into the reduce instead of persisting
            gt = pT[:, None, :] > pT[:, :, None]
            eq = (pT[:, None, :] == pT[:, :, None]) & lt[None]
            hit = (gt | eq) & suppress[None] & K[:, None, :]
            return active & ~jnp.any(hit, axis=-1)

    def cond(st):
        lo, hi = st
        return jnp.any(lo != hi)

    def body(st):
        lo, hi = st
        return lo | step(hi), hi & step(lo)

    kept, _ = lax.while_loop(
        cond, body, (jnp.zeros_like(active), active))
    return jnp.where(kept.T, probs, 0.0)
