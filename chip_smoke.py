#!/usr/bin/env python
"""On-card smoke test: yolov4-608 serving and training through the public
entry points, on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: data-parallel training and
                                   # batch-sharded serving, each against
                                   # one card, and nothing else

Phases (one process holds the card; weights are random, made from a seed):

  device    JAX must report a GPU; no CPU fallback.  Prints the card's name
            and power limit and which optional modules (cv2, PIL, orbax)
            import here.
  serving   `Network.from_cfg(yolov4_cfg(608, 608))`, BN folded, through
            `submit_detect_device` / `detect_batch_device` at batch 1 and
            32, bf16 and int8 (static calibration).  Compile time,
            `memory_analysis()`, step time with `block_until_ready`.
  heads     head tensors at 608, batch 1: the f32 HIGHEST path and the bf16
            path on the card against the CPU backend's f32 forward.
  nms       device NMS (`detect_batch_device`) against host NMS
            (`detect_batch`) on the f32 path.
  train     `DetectorTrainer` at yolov4-608 with the cfg's batch=64
            subdivisions=8: a few steps, finite and falling loss.
  grad      one micro-batch gradient (f32 HIGHEST, yolov4 with leaky
            switched to mish) on the card against the CPU's, by per-layer
            relative norm; the gradient with bf16 convs, and the one of
            an input rounded at TF32's step, must fail the same check.
  trace     `utils.profiler.trace_report` attributes device time to layers.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

SIZE = 608

# Tolerances, each with its precision and reason.
#
# The card sums in another order than the CPU (cuDNN algorithms, atomics in
# the loss scatters), so its f32 results agree with the CPU's only as far
# as the computation is well conditioned.  Each f32 comparison prints that
# floor, measured in the same run: the CPU's own change when every input
# pixel moves by one f32 rounding step (`perturbed`, relative 2^-23).
#
# f32 HIGHEST head tensors on the card vs the CPU's f32 (relative L2 per
# head).  The one-step floor of yolov4-608's heads is 8e-5 to 2.4e-4; TF32
# (2^-11 rounding) or bf16 convs land at 1e-2 or more.
HEADS_F32_RTOL = 1e-3
# bf16 operands, f32 accumulation: the bf16 path's distance from the CPU's
# f32 heads may be at most this multiple of the CPU's own bf16 path's
# distance (both are dominated by the same bf16 roundings, amplified).
HEADS_BF16_VS_CPU = 2.0
# The gradient comparisons run yolov4 with its leaky activations switched
# to mish (`smooth_cfg`).  Leaky's derivative jumps from 1 to 0.1 at 0, so
# the gradient is a discontinuous function of the forward values: a
# rounding difference flips the elements nearest 0 and moves every
# upstream layer's gradient by ~5%.  With mish the gradient is smooth: its
# one-step floor at 608 is ~2.5e-3 per layer, and the card's f32 HIGHEST
# gradient sits at ~2e-2 from the CPU's (rounding differs at each of ~220
# forward and backward layers, not only at the input), while bf16 convs
# land at ~1.5.  The micro-batch gradient, f32 HIGHEST on both sides:
# relative L2 per layer (all of the layer's parameter gradients together).
GRAD_F32_RTOL = 5e-2
# a rounding step of TF32's size (2^-11) applied to the input alone: the
# gradient check's control for TF32 convolutions, which round at that step
# at every layer
TF32_STEP = 2.0 ** -11
# device NMS vs host NMS on the same f32 candidates: boxes (absolute) and
# class probabilities.
NMS_BOX_ATOL = 1e-4
NMS_PROB_RTOL, NMS_PROB_ATOL = 1e-4, 1e-5
# four cards vs one, f32 HIGHEST, smooth cfg with decay=0 (so the update
# is the gradient, scaled): parameter update per layer (relative L2; the
# cards' sums run in another order, as the CPU's do), and the step's cost
# (relative).
DP_UPDATE_RTOL = GRAD_F32_RTOL
DP_COST_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# comparison helpers (pure numpy; the CPU tests drive them at a tiny cfg)
# ---------------------------------------------------------------------------

def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||; 0 when both are zero, inf when only ref is."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    num = float(np.linalg.norm((got - ref).ravel()))
    den = float(np.linalg.norm(ref.ravel()))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def compare_heads(got: list, ref: list, rtol: float) -> tuple:
    """Per-head relative L2 of `got` against `ref`.
    Returns (ok, [rel per head])."""
    if len(got) != len(ref):
        return False, []
    rels = []
    for g, r in zip(got, ref):
        if np.shape(g) != np.shape(r) or not np.all(np.isfinite(g)):
            return False, rels + [float("inf")]
        rels.append(rel_l2(g, r))
    return all(e <= rtol for e in rels), rels


def match_detections(dev: list, host: list, *, box_atol=NMS_BOX_ATOL,
                     prob_rtol=NMS_PROB_RTOL, prob_atol=NMS_PROB_ATOL):
    """Pair each host detection with a device detection of the same class
    whose box agrees within `box_atol` and whose class probabilities agree
    within (prob_rtol, prob_atol).  Returns (ok, message)."""
    if len(dev) != len(host):
        return False, f"{len(dev)} device vs {len(host)} host detections"
    left = list(dev)
    for h in host:
        hb = np.asarray(h.bbox)
        found = None
        for i, d in enumerate(left):
            if (d.best_class == h.best_class
                    and np.max(np.abs(np.asarray(d.bbox) - hb)) <= box_atol
                    and np.allclose(d.prob, h.prob, rtol=prob_rtol,
                                    atol=prob_atol)):
                found = i
                break
        if found is None:
            return False, f"host detection {h.bbox} class {h.best_class} " \
                          f"has no device match"
        left.pop(found)
    return True, f"{len(host)} detections match"


def layer_errors(got: list, ref: list) -> dict:
    """{layer index: relative L2 over all of the layer's float arrays} for
    params or gradients given as lists of dicts; inf where `got` is not
    finite."""
    errs = {}
    for i, (g, r) in enumerate(zip(got, ref)):
        keys = sorted(k for k in r if np.issubdtype(np.asarray(r[k]).dtype,
                                                    np.floating))
        if not keys:
            continue
        gv = np.concatenate([np.asarray(g[k], np.float64).ravel()
                             for k in keys])
        rv = np.concatenate([np.asarray(r[k], np.float64).ravel()
                             for k in keys])
        errs[i] = rel_l2(gv, rv) if np.all(np.isfinite(gv)) else float("inf")
    return errs


def within(errs: dict, rtol: float) -> tuple:
    """Check errs[k] <= rtol for every key.  Returns (ok, worst key, its
    error)."""
    k = max(errs, key=errs.get)
    return errs[k] <= rtol, k, errs[k]


def summary(errs: dict) -> str:
    v = list(errs.values())
    return f"median {np.median(v):.2e}, max {max(v):.2e}"


def update_errors(p0: list, ref: list, got: list) -> dict:
    """layer_errors of `got`'s parameter update (got - p0) against `ref`'s,
    over the arrays a gradient moves (w, b, scales; not the rolling BN
    statistics, which come from the forward alone)."""
    def update(p):
        return [{k: np.asarray(p[i][k]) - np.asarray(p0[i][k])
                 for k in ("w", "b", "scales") if k in p0[i]}
                for i in range(len(p0))]

    return layer_errors(update(got), update(ref))


def perturbed(x, seed: int = 0, step: float = 2.0 ** -23):
    """`x` with every element moved by `step` relative, random sign; by
    default one unit in its last f32 place: the noise floor's input."""
    x = np.asarray(x, np.float32)
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], x.shape)
    return (x * (1.0 + sign * step)).astype(np.float32)


def conv_dtype_tally(hlo_text: str) -> dict:
    """Count the convolutions of a compiled HLO module by (input dtype,
    filter dtype, output dtype, op): plain `convolution` ops, and on the
    GPU the cuDNN custom calls XLA rewrites them into.  Operand dtypes come
    from the defining instructions, since a call site names its operands
    without their types."""
    import re

    dtype = {}
    for m in re.finditer(r"%([\w.\-]+) = \(?([a-z][a-z0-9]*)\[", hlo_text):
        dtype[m.group(1)] = m.group(2)
    tally = {}
    for m in re.finditer(
            r"= \(?([a-z][a-z0-9]*)\[[^\n]*?(convolution|custom-call)"
            r"\(%([\w.\-]+), %([\w.\-]+)[^\n]*", hlo_text):
        line = m.group(0)
        if m.group(2) == "custom-call":
            t = re.search(r'custom_call_target="([^"]+)"', line)
            if not t or "conv" not in t.group(1):
                continue
            op = t.group(1)
        else:
            op = "convolution"
        key = (dtype.get(m.group(3)), dtype.get(m.group(4)), m.group(1), op)
        tally[key] = tally.get(key, 0) + 1
    return tally


def synth_batch(rng, n: int, size: int, max_boxes: int):
    """n `data.synth.draw_sample` images at `size` as float32 [0,1] NHWC,
    and their truths (n, max_boxes, 5) [x, y, w, h, class]."""
    from darknet_tpu.data.synth import draw_sample

    x = np.zeros((n, size, size, 3), np.float32)
    t = np.zeros((n, max_boxes, 5), np.float32)
    for i in range(n):
        img, boxes = draw_sample(rng, size, size)
        x[i] = img.astype(np.float32) / 255.0
        for j, (c, bx, by, bw, bh) in enumerate(boxes[:max_boxes]):
            t[i, j] = (bx, by, bw, bh, c)
    return x, t


def candidate_thresh(net, x, top_k: int, floor: float = 0.05) -> float:
    """An objectness threshold that leaves at most `top_k` candidates in
    every image of `x` (host decode), so the device path's top-k cap cuts
    nothing and it sees the host path's candidates."""
    _heads, dec = net.forward_heads(x)
    obj = -np.sort(-np.asarray(dec[1]), axis=1)
    return float(max(floor, obj[:, min(top_k, obj.shape[1] - 1)].max()))


def write_seeded_weights(cfg: str, path: str, seed: int, x) -> None:
    """Write a `.weights` file of seeded random weights whose BN rolling
    statistics are the batch statistics of `x` (one train-mode forward on
    the CPU), and whose head convs are rescaled so each raw head channel
    has mean 0 and variance 1 over `x`.  With the initial mean 0 / var 1
    the activations of a deep random net shrink layer by layer until every
    objectness is 0.5; unscaled heads saturate it at 1.0.  With these
    weights each layer's output is normalised as in training, so the
    heads, the detections and NMS carry real signal."""
    import jax

    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib
    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.weights import io as wio

    graph = build_graph(cfg, train=True)
    params = paramlib.init_params(graph, seed=seed)
    cpu = jax.devices("cpu")[0]
    fwd = jax.jit(make_forward(graph, train=True))
    r = jax.device_get(fwd(jax.device_put(params, cpu),
                           jax.device_put(x, cpu)))
    for i, (mean, var) in r["bn_stats"].items():
        params[i] = dict(params[i], mean=np.asarray(mean, np.float32),
                         var=np.asarray(var, np.float32))
    heads = [l for l in graph.layers if l.kind in ("yolo", "gaussian_yolo")]
    for l, raw in zip(heads, r["raw_heads"]):
        raw = np.asarray(raw, np.float64)
        mean = raw.mean(axis=(0, 1, 2))
        std = np.maximum(raw.std(axis=(0, 1, 2)), 1e-6)
        p = params[l.index - 1]
        params[l.index - 1] = dict(
            p, w=(p["w"] / std).astype(np.float32),
            b=((p["b"] - mean) / std).astype(np.float32))
    wio.save_weights(graph, params, path)


def micro_grads_fn(graph, compute_dtype=None):
    """Jitted gradient of one micro-batch (the gradient make_train_step
    accumulates), computed where its inputs live; f32 HIGHEST unless
    `compute_dtype` says otherwise."""
    import jax

    from darknet_tpu.train.step import make_micro_grads

    g = make_micro_grads(graph, compute_dtype=compute_dtype)
    return jax.jit(lambda p, x, t: g(p, x, t, None)[:2])


def dp_cfg(cfg: str) -> str:
    """The four-card comparison's cfg: trainable now, smooth, and with
    decay=0, so a parameter update is the scaled gradient alone."""
    import re

    return re.sub(r"decay=[0-9.]+", "decay=0", smooth_cfg(trainable_now(cfg)))


def smooth_cfg(cfg: str) -> str:
    """`cfg` with its leaky activations switched to mish, for the gradient
    comparisons (see GRAD_F32_RTOL): every layer kind and width stays."""
    return cfg.replace("activation=leaky", "activation=mish")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Smoke:
    def __init__(self):
        self.failed = []
        self._weights = None
        self._images = None
        from darknet_tpu.utils.card import nvidia_smi_name_power

        self.card = nvidia_smi_name_power()

    def weights(self) -> str:
        """Path of the serving phases' seeded `.weights` (made once), with
        BN statistics from `self.images`."""
        if self._weights is None:
            path = os.path.join(tempfile.mkdtemp(prefix="smoke_w_"),
                                "yolov4-seeded.weights")
            t0 = time.perf_counter()
            write_seeded_weights(yolov4_cfg_text(), path, 0, self.images())
            log(f"    seeded weights, BN statistics from "
                f"{len(self.images())} images on the CPU: "
                f"{time.perf_counter() - t0:.1f} s")
            self._weights = path
        return self._weights

    def images(self):
        """The serving phases' 16 draw_sample images.  The random net's
        features only stay in range on the images its BN statistics came
        from, so serving runs on these."""
        if self._images is None:
            self._images = synth_batch(np.random.default_rng(9), 16, SIZE,
                                       90)[0]
        return self._images

    def batch32(self):
        """32 serving images: the 16, then the 16 reversed (a mix-up of
        batch shards shows)."""
        x = self.images()
        return np.concatenate([x, x[::-1]])

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        log(f"=== phase {name}")
        try:
            fn(*args)
            log(f"=== phase {name}: PASS ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            log(f"=== phase {name}: FAIL ({time.perf_counter() - t0:.1f} s)")

    def timed(self, label, fn, iters=10):
        """Median of 3 windows of `iters` calls, each ended by
        block_until_ready; ms per call."""
        import jax

        jax.block_until_ready(fn())
        ws = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            jax.block_until_ready(out)
            ws.append((time.perf_counter() - t0) / iters * 1e3)
        ms = float(np.median(ws))
        log(f"    {label}: {ms:.3f} ms/call (median of {ws}) [{self.card}]")
        return ms


def trainable_now(cfg: str) -> str:
    """`cfg` with burn_in=0 (the zoo's 1000-step warm-up would hold the LR
    at ~1e-15 for a smoke test's few steps) and random=0 (multi-scale would
    open at the largest bucket, not at the cfg's size)."""
    return cfg.replace("burn_in=1000", "burn_in=0").replace(
        "random=1", "random=0")


def yolov4_cfg_text(batch=64, subdiv=8):
    """The zoo's yolov4 at SIZE (608)."""
    from darknet_tpu import model_zoo

    return model_zoo.yolov4_cfg(SIZE, SIZE, batch=batch, subdiv=subdiv)


def phase_device(smoke):
    from darknet_tpu.utils.card import require_gpu

    smoke.device = require_gpu()
    log(f"    device: {smoke.device}")
    log(f"    card: {smoke.card}")
    for mod in ("cv2", "PIL", "orbax.checkpoint"):
        try:
            __import__(mod)
            log(f"    import {mod}: yes")
        except Exception as e:
            log(f"    import {mod}: no ({e.__class__.__name__})")


def phase_serving(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.nn.network import Network

    cfg = yolov4_cfg_text()
    x32 = smoke.batch32()
    x1 = x32[:1]
    w = smoke.weights()
    nets = {"bf16": Network.from_cfg(cfg, w, compute_dtype=jnp.bfloat16)}
    t0 = time.perf_counter()
    q = Network.from_cfg(cfg, w, compute_dtype=jnp.bfloat16, int8=True)
    q.calibrate_int8([x32[:4]])
    log(f"    int8 static calibration (4 images at {SIZE}): "
        f"{time.perf_counter() - t0:.1f} s")
    n_q = sum(1 for p in q.params if "x_scale" in p)
    check(n_q > 0, "int8: no conv got a static activation scale")
    nets["int8"] = q
    texts = {}
    for name, net in nets.items():
        for b, x in ((1, x1), (32, x32)):
            xd = jax.device_put(x)
            t0 = time.perf_counter()
            dets = net.detect_batch_device(xd, thresh=0.25)
            t_first = time.perf_counter() - t0
            check(len(dets) == b, f"{name} b{b}: {len(dets)} results")
            fn = net._device_detect_fn(b, SIZE, SIZE, 0.25, 0.45, 256)
            compiled = fn.lower(net.params, xd).compile()
            if b == 1:
                texts[name] = compiled.as_text()
            log(f"    {name} b{b}: compile + first call {t_first:.1f} s "
                f"[{smoke.card}]")
            log(f"    {name} b{b}: memory_analysis "
                f"{compiled.memory_analysis()}")
            tb, ov, probs = net.submit_detect_device(xd, thresh=0.25)
            for a in (tb, ov, probs):
                check(bool(jnp.all(jnp.isfinite(a))), f"{name} b{b}: "
                      "non-finite serving output")
            check(tb.shape[0] == b and tb.shape[2] == 4,
                  f"{name} b{b}: boxes {tb.shape}")
            smoke.timed(f"{name} b{b} submit_detect_device step",
                        lambda: net.submit_detect_device(xd, thresh=0.25))
            log(f"    {name} b{b}: {sum(len(d) for d in dets)} detections")
    for name, text in texts.items():
        for (xt, wt, yt, op), n in sorted(conv_dtype_tally(text).items(),
                                          key=lambda kv: -kv[1]):
            log(f"    {name} b1 program: {n} convs {xt} x {wt} -> {yt} "
                f"as {op}")
    if smoke.device["platform"] == "gpu":
        s8 = sum(n for (xt, wt, _, _), n in conv_dtype_tally(
            texts["int8"]).items() if xt == wt == "s8")
        check(s8 > 0, "the int8 program runs no convolution on int8 "
                      "operands")


def phase_heads(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.nn.network import Network

    cfg = yolov4_cfg_text()
    x = smoke.images()[:1]
    net32 = Network.from_cfg(cfg, smoke.weights())      # f32 HIGHEST
    cpu = jax.devices("cpu")[0]
    p_cpu = jax.device_put(net32.params, cpu)

    def cpu_heads(x, compute_dtype=None):
        fwd = jax.jit(make_forward(net32.graph, fused_bn=True,
                                   compute_dtype=compute_dtype))
        return [np.asarray(h, np.float32)
                for h in fwd(p_cpu, jax.device_put(x, cpu))["heads"]]

    ref = cpu_heads(x)
    _, floor = compare_heads(cpu_heads(perturbed(x)), ref, 1.0)
    log(f"    CPU f32 floor (input moved by one rounding step), rel L2 per "
        f"head: {floor}")
    got32, _ = net32.forward_heads(x)
    ok, rels = compare_heads(got32, ref, HEADS_F32_RTOL)
    log(f"    f32 HIGHEST card vs CPU f32, rel L2 per head: {rels} "
        f"(tolerance {HEADS_F32_RTOL})")
    check(ok, "f32 heads disagree with the CPU")
    _, cpu16 = compare_heads(cpu_heads(x, jnp.bfloat16), ref, 1.0)
    net16 = Network(net32.graph, net32.params, fused=True,
                    compute_dtype=jnp.bfloat16)
    got16, _ = net16.forward_heads(x)
    _, rels16 = compare_heads(got16, ref, 1.0)
    log(f"    bf16 vs CPU f32, rel L2 per head: card {rels16}, CPU's own "
        f"bf16 path {cpu16} (bound {HEADS_BF16_VS_CPU} x the CPU's)")
    check(all(e <= HEADS_BF16_VS_CPU * c for e, c in zip(rels16, cpu16)),
          "bf16 heads disagree with the CPU")


def phase_nms(smoke):
    from darknet_tpu.nn.network import Network

    net = Network.from_cfg(yolov4_cfg_text(), smoke.weights())  # f32
    x = smoke.images()[1:2]
    top_k = 1024
    thresh = candidate_thresh(net, x, top_k)
    host = net.detect_batch(x, thresh=thresh, nms=0.45)[0]
    dev = net.detect_batch_device(x, thresh=thresh, nms=0.45,
                                  top_k=top_k)[0]
    ok, msg = match_detections(dev, host)
    log(f"    thresh {thresh:.4f}: {msg}")
    check(ok, msg)
    check(len(host) > 0, "no detections to compare")


def phase_train(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.train.schedule import get_lr
    from darknet_tpu.train.trainer import DetectorTrainer

    cfg = trainable_now(yolov4_cfg_text())
    work = tempfile.mkdtemp(prefix="smoke_train_")
    paths, have_cv2 = train_paths(work, 64, (480, 640))
    if not have_cv2:
        log("    cv2 does not import: the loader (OpenCV augmentation) is "
            "NOT exercised; the trainer's own jitted step is fed "
            "draw_sample batches")
    metrics = os.path.join(work, "metrics.jsonl")
    trainer = DetectorTrainer(cfg, paths, classes=80, seed=0,
                              save_dir=os.path.join(work, "backup"),
                              full_state=False, metrics_path=metrics,
                              log=lambda *a: None)
    net = trainer.net
    log(f"    trainer: batch={net.batch * net.subdiv} (optimizer batch "
        f"{net.optimizer_batch}) subdivisions={net.subdiv} "
        f"compute={trainer.compute_dtype} act16={trainer.act16} "
        f"metric_lag={trainer.metric_lag}; cfg cut: burn_in=0, random=0")
    steps = 5
    losses = []
    try:
        if have_cv2:
            t0 = time.perf_counter()
            trainer.train(max_iters=1)
            log(f"    compile + first step: {time.perf_counter() - t0:.1f} s "
                f"[{smoke.card}]")
            t0 = time.perf_counter()
            trainer.train(max_iters=steps - 1)
            dt = (time.perf_counter() - t0) / (steps - 1)
            log(f"    {dt * 1e3:.1f} ms/step over {steps - 1} steps, loader "
                f"included, {net.optimizer_batch / dt:.1f} img/s "
                f"[{smoke.card}]")
            with open(metrics) as f:
                losses = [json.loads(ln)["loss"] for ln in f
                          if '"step"' in ln]
            workers = _loader_worker_pids(trainer)
            opened = [p for p in workers if _opens_gpu(p)]
            log(f"    loader workers: {len(workers)} processes, "
                f"{len(opened)} with the GPU open")
            check(not opened, f"loader workers {opened} opened the GPU")
        else:
            step = trainer._step_for(net.w, net.h)
            rng = np.random.default_rng(4)
            for i in range(steps):
                x, t = synth_batch(rng, net.optimizer_batch, SIZE,
                                   trainer.max_boxes)
                lr = get_lr(net, trainer.curr_iter + 1)
                t0 = time.perf_counter()
                trainer.params, trainer.opt_state, cost, m = step(
                    trainer.params, trainer.opt_state, jnp.asarray(x),
                    jnp.asarray(t), jax.random.PRNGKey(i), jnp.float32(lr))
                jax.block_until_ready(cost)
                trainer.seen += net.optimizer_batch
                losses.append(float(m["loss"]))
                log(f"    step {i}: {time.perf_counter() - t0:.2f} s "
                    f"[{smoke.card}]")
    finally:
        trainer.close()
    log(f"    losses: {losses}")
    check(len(losses) == steps, f"{len(losses)} losses for {steps} steps")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"    peak device memory: {peak} bytes")


def train_paths(work: str, n: int, size: tuple) -> tuple:
    """(paths, have_cv2): n `data.synth` training images of `size` pixels
    (width range; height 3/4 of it) written under `work` when cv2 imports;
    placeholders otherwise (the loader then yields blank samples)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return [os.path.join(work, "missing.png")] * n, False
    from darknet_tpu.data.synth import generate

    lo, hi = size
    files = generate(os.path.join(work, "ds"), n_train=n, n_val=1, seed=3,
                     size_range=((lo, hi), (lo * 3 // 4, hi * 3 // 4)))
    return files["train_paths"], True


def _loader_worker_pids(trainer) -> list:
    procs = getattr(trainer.loader.pool, "_processes", None) or {}
    return sorted(procs)


def _opens_gpu(pid: int) -> bool:
    """True if process `pid` holds an NVIDIA device file or maps libcuda."""
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                        "/dev/nvidia"):
                    return True
            except OSError:
                pass
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda" in f.read()
    except OSError:
        return False


def phase_grad(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib

    graph = build_graph(smooth_cfg(yolov4_cfg_text()), train=True)
    micro = graph.net.batch           # optimizer batch / subdivisions
    params = paramlib.init_params(graph, seed=0)
    x, t = synth_batch(np.random.default_rng(5), micro, SIZE,
                       graph.heads()[-1].max_boxes)
    fn = micro_grads_fn(graph)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    g_ref, c_ref = jax.device_get(fn(*jax.device_put((params, x, t), cpu)))
    g_flo, _ = jax.device_get(fn(*jax.device_put((params, perturbed(x), t),
                                                 cpu)))
    log(f"    CPU f32 micro-batch ({micro} images) gradient, twice: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g_dev, c_dev = jax.device_get(fn(params, x, t))
    log(f"    card f32 HIGHEST gradient: {time.perf_counter() - t0:.1f} s "
        f"(compile included) [{smoke.card}]")
    # controls: the same check must reject the gradient with bf16 conv
    # operands, and the f32 one of an input rounded at TF32's step, or the
    # tolerance cannot tell f32 from reduced precision
    controls = {
        "bf16 convs": micro_grads_fn(graph, jnp.bfloat16)(params, x, t)[0],
        "input at TF32 step": fn(params, perturbed(x, step=TF32_STEP),
                                 t)[0]}
    errs = layer_errors(g_dev, g_ref)
    ok, wi, worst = within(errs, GRAD_F32_RTOL)
    log(f"    cost card {float(c_dev):.6f} vs CPU {float(c_ref):.6f}; "
        f"per-layer rel L2 over {len(errs)} layers: {summary(errs)}, worst "
        f"layer {wi} (tolerance {GRAD_F32_RTOL}); CPU one-step floor "
        f"{summary(layer_errors(g_flo, g_ref))}")
    check(ok, "gradient disagrees with the CPU")
    for name, g in controls.items():
        c_errs = layer_errors(jax.device_get(g), g_ref)
        c_ok, _, _ = within(c_errs, GRAD_F32_RTOL)
        log(f"    control, {name}: {summary(c_errs)}")
        check(not c_ok, f"the tolerance does not reject {name}")


def phase_trace(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib
    from darknet_tpu.nn.emit import make_forward
    from darknet_tpu.utils.profiler import trace_report

    graph = build_graph(yolov4_cfg_text())
    params = jax.device_put(paramlib.fuse_conv_batchnorm(
        graph, paramlib.init_params(graph, seed=0)))
    fwd = make_forward(graph, fused_bn=True, compute_dtype=jnp.bfloat16)
    x = jax.device_put(smoke.images()[:1])
    lines = []
    rows = trace_report(lambda p, x: fwd(p, x)["heads"], params, x,
                        graph=graph, iters=3, log=lines.append, top=12)
    for ln in lines:
        log("    " + ln)
    layers = [r for r in rows if r[0].startswith("L")]
    total = sum(r[1] for r in rows)
    check(total > 0, "no device time in the trace")
    scopes = {r[0] for r in rows}
    missing = [l.index for l in graph.layers if l.kind == "convolutional"
               and f"L{l.index:03d}_convolutional" not in scopes]
    check(not missing, f"conv layers without device time: {missing}")
    log(f"    {len(layers)} layer scopes attributed, "
        f"{sum(r[1] for r in layers) / total:.1%} of device time "
        f"[{smoke.card}]")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_train(smoke):
    import jax
    import jax.numpy as jnp

    from darknet_tpu.parallel import make_mesh, replicate, shard_batch
    from darknet_tpu.train.trainer import DetectorTrainer

    cfg = dp_cfg(yolov4_cfg_text())
    mesh = make_mesh(4)
    work = tempfile.mkdtemp(prefix="smoke_dp_")
    kw = dict(classes=80, seed=0, compute_dtype=jnp.float32, act16=False,
              full_state=False, save_dir=work, log=lambda *a: None,
              loader_processes=0, loader_threads=1)
    paths, _ = train_paths(work, 4, (64, 64))
    one = DetectorTrainer(cfg, paths, **kw)
    four = DetectorTrainer(cfg, paths, mesh=mesh, **kw)
    one.close()
    four.close()
    net = one.net
    x, t = synth_batch(np.random.default_rng(7), net.optimizer_batch, SIZE,
                       one.max_boxes)
    lr = jnp.float32(1e-3)
    key = jax.random.PRNGKey(0)
    p0 = jax.device_get(one.params)
    s1 = one._step_for(net.w, net.h)
    s4 = four._step_for(net.w, net.h)
    xs, ts = shard_batch(mesh, x), shard_batch(mesh, t)
    devs = {s.device for s in xs.addressable_shards}
    shapes = {s.data.shape[0] for s in xs.addressable_shards}
    log(f"    batch shards: {len(devs)} devices, rows per shard {shapes}")
    check(len(devs) == 4 and shapes == {net.optimizer_batch // 4},
          "the batch is not split one shard per card")
    o0 = jax.device_get(one.opt_state)
    t0 = time.perf_counter()
    p1, _o1, c1, _ = s1(one.params, one.opt_state, jnp.asarray(x),
                        jnp.asarray(t), key, lr)
    jax.block_until_ready(c1)
    log(f"    one card: compile + step {time.perf_counter() - t0:.1f} s")
    pf, _of, _cf, _ = s1(jax.device_put(p0), jax.device_put(o0),
                         jnp.asarray(perturbed(x)), jnp.asarray(t), key, lr)
    t0 = time.perf_counter()
    p4, _o4, c4, _ = s4(four.params, four.opt_state, xs, ts,
                        replicate(mesh, key), replicate(mesh, lr))
    jax.block_until_ready(c4)
    log(f"    four cards: compile + step {time.perf_counter() - t0:.1f} s")
    leaf = jax.tree_util.tree_leaves(p4)[0]
    held = {s.device for s in leaf.addressable_shards}
    check(len(held) == 4, f"params live on {len(held)} cards")
    p1, p4, pf = jax.device_get((p1, p4, pf))
    errs = update_errors(p0, p1, p4)
    ok, wi, worst = within(errs, DP_UPDATE_RTOL)
    cost_rel = abs(float(c4) - float(c1)) / max(abs(float(c1)), 1e-30)
    log(f"    cost four {float(c4):.6f} vs one {float(c1):.6f} "
        f"(rel {cost_rel:.2e}, tolerance {DP_COST_RTOL}); parameter update "
        f"per-layer rel L2 over {len(errs)} layers: {summary(errs)}, worst "
        f"layer {wi} (tolerance {DP_UPDATE_RTOL}); one-card one-step floor "
        f"{summary(update_errors(p0, p1, pf))} [{smoke.card}]")
    check(cost_rel <= DP_COST_RTOL, "four-card cost disagrees")
    check(ok, "four-card update disagrees")


def phase_four_serve(smoke):
    import jax

    from darknet_tpu.nn.network import Network
    from darknet_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    net = Network.from_cfg(yolov4_cfg_text(), smoke.weights())  # f32
    x = smoke.batch32()
    thresh = candidate_thresh(net, x, 256)
    # the one-card reference runs the per-card batch (8), so both sides
    # run the same convolution shapes and the same cuDNN algorithms
    single = [d for i in range(0, 32, 8)
              for d in net.detect_batch_device(x[i:i + 8], thresh=thresh,
                                               top_k=256)]
    tb, ov, probs = net.submit_detect_device(x, thresh=thresh, top_k=256,
                                             mesh=mesh)
    devs = {s.device for s in tb.addressable_shards}
    rows = {s.data.shape[0] for s in tb.addressable_shards}
    log(f"    output shards: {len(devs)} devices, rows per shard {rows}")
    check(len(devs) == 4 and rows == {8},
          "serving output is not batch-sharded over four cards")
    sharded = Network.device_out_to_dets(tb, ov, probs)
    n = 0
    for i, (a, b) in enumerate(zip(sharded, single)):
        ok, msg = match_detections(a, b)
        check(ok, f"image {i}: {msg}")
        n += len(b)
    log(f"    sharded vs one card (thresh {thresh:.4f}): {n} detections "
        f"over 32 images match")
    check(n > 0, "no detections to compare")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: data-parallel training and "
                         "batch-sharded serving against one card only")
    args = ap.parse_args(argv)

    from darknet_tpu.utils.card import NoGPUError, require_gpu

    try:
        require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 1
    from darknet_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    smoke = Smoke()
    smoke.phase("device", phase_device, smoke)
    if smoke.failed:
        return 1
    if args.four:
        check(smoke.device["count"] >= 4,
              f"--four needs 4 cards, found {smoke.device['count']}")
        phases = (("four_train", phase_four_train),
                  ("four_serve", phase_four_serve))
    else:
        phases = (("serving", phase_serving), ("heads", phase_heads),
                  ("nms", phase_nms), ("train", phase_train),
                  ("grad", phase_grad), ("trace", phase_trace))
    for name, fn in phases:
        smoke.phase(name, fn, smoke)
    log(smoke.card)
    if smoke.failed:
        log(f"FAILED phases: {smoke.failed}")
        return 1
    print(json.dumps({"ok": True, "device": smoke.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
