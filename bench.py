#!/usr/bin/env python
"""Benchmark: YOLOv4 608x608 serving and training rates on one GPU.

Measures, on seeded random weights:
  * int8 serving (static calibration) and bf16 serving at batch 256 —
    the full serving program: NHWC forward (bf16 tensor-core compute, f32
    accumulation), folded BN, on-device YOLO decode for all three heads,
    objectness top-k and exact greedy NMS;
  * batch-1 latency, synchronous and amortized, on the int8 program;
  * one-card training (batch 8, act16, bf16) with 3 steps in flight and
    blocking.

Every time ends in `jax.block_until_ready`.  Without a GPU the script
exits non-zero; it never falls back to the CPU.  It prints the device
(`platform`, `device_kind`, count) and the card's name and power limit,
then ONE JSON line.

    python bench.py [batch] [--bf16] [--headline-only] [--no-train]
"""

import json
import sys
import time

import numpy as np


def main():
    from darknet_tpu.utils.card import (NoGPUError, nvidia_smi_name_power,
                                        require_gpu)

    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        sys.exit(1)
    card = nvidia_smi_name_power()
    print(f"device: {device}  card: {card}", flush=True)

    from darknet_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import jax
    import jax.numpy as jnp

    from darknet_tpu import model_zoo
    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib
    from darknet_tpu.nn.network import Network

    # positional batch override; skip flags and non-numeric tokens (the
    # CLI's `-mode bench` dispatch leaves "bench" in argv)
    args = [a for a in sys.argv[1:]
            if not a.startswith("-") and a.isdigit()]
    with_train = "--no-train" not in sys.argv
    bf16_headline = "--bf16" in sys.argv
    both = not bf16_headline and "--headline-only" not in sys.argv
    batch = int(args[0]) if args else 256
    size = 608

    graph = build_graph(model_zoo.yolov4_cfg(size, size))
    base_params = paramlib.init_params(graph, seed=0)
    base_params = paramlib.fuse_conv_batchnorm(graph, base_params)

    def make_params(int8):
        params = base_params
        if int8:
            params = paramlib.quantize_conv_params(graph, params)
            # static activation calibration (TensorRT-style): bakes per-conv
            # input scales so serving skips the per-conv dynamic absmax
            # reduce.  Ranges are resolution-robust, so probe at 320^2.
            # Scales from synthetic noise on random weights are valid for
            # TIMING only; int8 accuracy with real calibration is gated by
            # tests/test_int8.py::test_int8_map_accuracy.
            gcal = build_graph(model_zoo.yolov4_cfg(320, 320))
            xcal = np.random.default_rng(7).uniform(
                0, 1, (4, 320, 320, 3)).astype(np.float32)
            absmax = paramlib.calibrate_conv_input_scales(
                gcal, params, [xcal], compute_dtype=jnp.bfloat16)
            params = paramlib.apply_conv_input_scales(
                params, absmax, graph=graph)
        return jax.device_put(params)

    def make_run(params, batch):
        # the measured program IS the production serving path: the Network
        # facade's on-device postprocess (forward -> decode -> obj
        # threshold -> top-k -> exact greedy NMS), bf16 serving scores
        net = Network(graph, params, fused=True, compute_dtype=jnp.bfloat16)
        return net._device_detect_fn(batch, size, size, 0.25, 0.45, 256,
                                      score_dtype=jnp.bfloat16)

    def measure_rate(run, params, x, iters=12, series=3):
        jax.block_until_ready(run(params, x))      # compile + warm
        rates = []
        for _series in range(series):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = run(params, x)
            jax.block_until_ready(out)
            rates.append(x.shape[0] * iters / (time.perf_counter() - t0))
        return float(np.median(rates))

    x = jax.device_put(np.random.default_rng(0).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32))

    params = make_params(int8=not bf16_headline)
    run = make_run(params, batch)
    img_s = measure_rate(run, params, x)

    bf16_img_s = None
    if both:
        params_bf16 = make_params(int8=False)
        run_bf16 = make_run(params_bf16, batch)
        bf16_img_s = measure_rate(run_bf16, params_bf16, x)
        del params_bf16

    # batch-1 latency on the headline config: synchronous per frame, and
    # amortized over 30 frames in flight
    run1 = make_run(params, 1)
    x1 = jax.device_put(np.asarray(x[:1]))
    jax.block_until_ready(run1(params, x1))
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(run1(params, x1))
        lat.append((time.perf_counter() - t0) * 1000)
    p50 = sorted(lat)[len(lat) // 2]
    t0 = time.perf_counter()
    for _ in range(30):
        out = run1(params, x1)
    jax.block_until_ready(out)
    b1_amortized = (time.perf_counter() - t0) / 30 * 1000

    train_img_s = train_img_s_blocking = None
    if with_train:
        from collections import deque

        from darknet_tpu.train.step import init_opt_state, make_train_step

        tb = 8
        graph_t = build_graph(model_zoo.yolov4_cfg(size, size))
        tp = jax.device_put(paramlib.init_params(graph_t, seed=0))
        topt = jax.device_put(init_opt_state(graph_t, tp))
        xt = jax.device_put(np.random.default_rng(1).uniform(
            0, 1, (tb, size, size, 3)).astype(np.float32))
        tr = np.zeros((tb, 90, 5), np.float32)
        tr[:, 0] = [0.3, 0.3, 0.2, 0.2, 1]
        tr = jax.device_put(tr)
        step = make_train_step(graph_t, compute_dtype=jnp.bfloat16,
                               remat=False, train_act_dtype=jnp.bfloat16)
        tp, topt, c, _m = step(tp, topt, xt, tr, jax.random.PRNGKey(0), 1e-4)
        jax.block_until_ready(c)                    # compile + settle

        def train_rate(lag, iters=12, series=3):
            nonlocal tp, topt
            times = []
            for _ in range(series):
                pend = deque()
                t0 = time.perf_counter()
                for _ in range(iters):
                    tp, topt, c, _m = step(tp, topt, xt, tr,
                                           jax.random.PRNGKey(1), 1e-4)
                    pend.append(c)
                    if len(pend) > lag:
                        jax.block_until_ready(pend.popleft())
                jax.block_until_ready(list(pend))
                times.append((time.perf_counter() - t0) / iters)
            return tb / float(np.median(times))

        train_img_s = train_rate(lag=3)
        train_img_s_blocking = train_rate(lag=0)
        del tp, topt, xt, tr

    line = {
        "metric": "yolov4-608 images/sec/card "
                  + ("(bf16" if bf16_headline else "(int8")
                  + " serving: on-device decode+top-k+NMS)",
        "value": img_s,
        "unit": "img/s",
        "p50_latency_ms_batch1_sync": p50,
        "batch1_ms_amortized": b1_amortized,
        "device": device,
        "card": card,
    }
    if bf16_img_s is not None:
        line["bf16_img_s"] = bf16_img_s
    if train_img_s is not None:
        line["train_608_img_s"] = train_img_s
        line["train_608_img_s_blocking"] = train_img_s_blocking
    print(json.dumps(line))


if __name__ == "__main__":
    main()
