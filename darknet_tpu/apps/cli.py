"""Command-line interface — the `yolo_core` executable's 5 modes
(yolo_core.cpp:139-399): train | valid | image | video | multi-video.

Flags mirror the gflags surface (yolo_core.cpp:24-42); run e.g.::

    python -m darknet_tpu.apps.cli -mode image -data_file coco.data \
        -model_file yolov4.cfg -weights_file yolov4.weights \
        -input_file dog.jpg -thresh 0.25

Flags accept both `-flag value` and `--flag=value` like gflags.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yolo_core", description=__doc__, prefix_chars="-",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-mode", "--mode", default="video",
                   choices=["train", "valid", "image", "video",
                            "multi-video", "bench"])
    p.add_argument("-data_file", "--data_file", default="yolo.data")
    p.add_argument("-model_file", "--model_file", default="yolo.cfg")
    p.add_argument("-weights_file", "--weights_file", default="yolo.weights")
    p.add_argument("-input_file", "--input_file", default="test.avi",
                   help="comma-separated for multiple files")
    p.add_argument("-thresh", "--thresh", type=float, default=0.5)
    p.add_argument("-nms_thresh", "--nms_thresh", type=float, default=0.45)
    p.add_argument("-clear", "--clear", action="store_true")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="restore the rolling full-state checkpoint "
                        "(<model>_last.ckpt.npz in the backup dir) for "
                        "exact resume incl. optimizer momentum — beyond "
                        "the reference's weights-only restart")
    p.add_argument("-show_imgs", "--show_imgs", action="store_true")
    p.add_argument("-save_output", "--save_output", action="store_true")
    p.add_argument("-calc_map", "--calc_map", action="store_true",
                   default=True)
    p.add_argument("-no_calc_map", "--no_calc_map", dest="calc_map",
                   action="store_false")
    p.add_argument("-disable_tracking", "--disable_tracking",
                   action="store_true")
    p.add_argument("-remat", "--remat", action="store_true",
                   help="rematerialize conv blocks in backward "
                        "(less memory, more FLOPs; for 608^2 training)")
    p.add_argument("-act16", "--act16", action="store_true",
                   help="force bf16 interlayer activations in training "
                        "(halves vjp-residual HBM traffic; BN stats f32). "
                        "Default: per platform (darknet_tpu/defaults.py)")
    p.add_argument("-no_act16", "--no_act16", action="store_true",
                   help="force f32 interlayer activations in training")
    p.add_argument("-metric_lag", "--metric_lag", type=int, default=-1,
                   help="iterations to keep in flight before fetching a "
                        "step's loss/metrics (async metrics pipeline; "
                        "0 = block every iteration like the reference). "
                        "Default: per platform (darknet_tpu/defaults.py)")
    p.add_argument("-benchmark_layers", "--benchmark_layers", type=int,
                   default=0)
    p.add_argument("-int8", "--int8", action="store_true",
                   help="quantized inference (int8 convs, the XNOR-path "
                        "analogue); dynamic activation scales unless "
                        "-int8_calib")
    p.add_argument("-calib_file", "--calib_file", default="",
                   help="int8 calibration cache: load it if present, "
                        "else save the freshly computed scales there "
                        "(pair with -int8_calib)")
    p.add_argument("-coco_map", "--coco_map", action="store_true",
                   help="valid mode: also report COCO AP@[.5:.95] "
                        "(10-threshold sweep from the same predictions)")
    p.add_argument("-int8_calib", "--int8_calib", type=int, default=0,
                   help="valid mode: calibrate static activation scales "
                        "on the first N val images")
    p.add_argument("-dbg_sync", "--dbg_sync", "-cuda_dbg_sync",
                   "--cuda_dbg_sync", type=int, default=0, dest="dbg_sync",
                   help="synchronous op dispatch + NaN fail-fast "
                        "(the cuda_dbg_sync analogue, utils/debug.py)")
    p.add_argument("-num_chips", "--num_chips", "-num_gpus", "--num_gpus",
                   type=int, default=1, dest="num_chips")
    p.add_argument("-loader_processes", "--loader_processes", type=int,
                   default=-1,
                   help="data-loader process workers (spawn pool); -1 = "
                   "auto (processes on multi-core hosts, threads on 1-2 "
                   "cores), 0 = thread pool (reference's 6-pthread model)")
    p.add_argument("-geo_info_file", "--geo_info_file", default="")
    p.add_argument("-out_dir", "--out_dir", default="output")
    p.add_argument("-letter_box", "--letter_box", action="store_true",
                   help="aspect-preserving letterbox resize at inference")
    p.add_argument("-metrics_file", "--metrics_file", default="",
                   help="JSONL per-step training metrics output")
    p.add_argument("-device_nms", "--device_nms", default="auto",
                   choices=["auto", "on", "off"],
                   help="serve through the on-device decode+top-k+NMS "
                        "program (the path bench.py measures); auto = per "
                        "platform (darknet_tpu/defaults.py).  NOTE: the "
                        "device path keeps "
                        "the top_k objectness candidates per frame before "
                        "NMS (the host path considers all) — raise -top_k "
                        "for dense scenes at low -thresh")
    p.add_argument("-top_k", "--top_k", type=int, default=256,
                   help="device serving path: candidates kept per image")
    p.add_argument("-pipeline_depth", "--pipeline_depth", type=int,
                   default=2,
                   help="video/multi-video: frames submitted to the "
                        "device before the oldest is finalized (1 = the "
                        "classic submit/finalize overlap; 2-3 hide the "
                        "full device+transfer latency behind host work "
                        "for throughput-mode streams).  Results are "
                        "finalized strictly in order, so tracking "
                        "semantics never change")
    p.add_argument("-latency", "--latency", action="store_true",
                   help="low-latency streaming preset: top_k=64 (a "
                        "cheaper device NMS), pipeline_depth=1 (freshest "
                        "result), uint8 frame ingest (already the "
                        "streaming default)")
    return p


def _use_device_nms(args) -> bool:
    mode = getattr(args, "device_nms", "auto")
    if mode == "on":
        return True
    if mode == "off":
        return False
    from darknet_tpu.defaults import platform_defaults

    return platform_defaults().device_nms


def _gui_ok() -> bool:
    from darknet_tpu.apps.visualize import gui_ok

    return gui_ok()


def _load_metadata(args):
    from darknet_tpu.config.metadata import Metadata

    return Metadata.from_file(args.data_file)


def _load_network(args, train=False):
    from darknet_tpu.nn.network import Network

    weights = args.weights_file if os.path.exists(args.weights_file) else None
    net = Network.from_cfg(args.model_file, weights=weights, train=train,
                           clear=args.clear,
                           int8=getattr(args, "int8", False) and not train)
    # per-layer construction table on stderr, like every LoadNetwork in
    # the reference (parser.cpp:1134-1135); golden-gated vs the binary
    print(net.graph.layer_table(), file=sys.stderr)
    calib = getattr(args, "calib_file", "")
    if not train and getattr(args, "int8", False) and calib and \
            os.path.exists(calib):
        # persisted static activation scales (see mode_valid, which can
        # also create this cache with -int8_calib -calib_file)
        net.load_calibration(calib)
    return net


def _host_tail(net, md, frame_bgr, dets, args, track_manager=None):
    """Shared per-frame host tail: letterbox box correction -> most-prob
    dets -> track -> draw.  The ONLY copy of this logic — the
    synchronous, pipelined and batched paths all delegate here."""
    import cv2

    from darknet_tpu.apps.tracker import get_most_prob_dets
    from darknet_tpu.apps import visualize as viz

    if getattr(args, "letter_box", False) and dets:
        from darknet_tpu.data.image import correct_boxes_letterbox

        ih, iw = frame_bgr.shape[:2]
        for d in dets:
            d.bbox = tuple(correct_boxes_letterbox(
                np.asarray(d.bbox), iw, ih, net.net.w, net.net.h))
    most_prob = get_most_prob_dets(dets)
    # cvtColor allocates a fresh buffer; no defensive copy needed
    disp_rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
    if track_manager is not None:
        track_manager.track(most_prob)
        viz.draw_trackings(disp_rgb, track_manager.get_tracks(), md.names)
    else:
        viz.draw_detections(disp_rgb, most_prob, md.names)
    return cv2.cvtColor(disp_rgb, cv2.COLOR_RGB2BGR), most_prob


def _proc_frame(net, md, frame_bgr, args, track_manager=None):
    """ProcImage (yolo_core.cpp:104-137): resize -> predict -> NMS ->
    most-prob dets -> track/draw.  The device path is literally
    submit + finalize (the streaming halves), the host path shares
    _host_tail — neither can drift from the pipelined code."""
    import cv2

    if _use_device_nms(args):
        # production serving path (VERDICT r2 #5): decode + top-k + exact
        # NMS on device, only top-k candidates leave HBM — the same
        # program bench.py measures
        return _finalize_frame(net, md, frame_bgr,
                               _submit_frame(net, frame_bgr, args), args,
                               track_manager=track_manager)
    rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    if getattr(args, "letter_box", False):
        from darknet_tpu.data.image import letterbox_image

        resized = letterbox_image(rgb, net.net.w, net.net.h)
    else:
        resized = cv2.resize(rgb, (net.net.w, net.net.h),
                             interpolation=cv2.INTER_LINEAR)
    dets = net.detect(resized, thresh=args.thresh, nms=args.nms_thresh)
    return _host_tail(net, md, frame_bgr, dets, args, track_manager)


def _serving_mesh(args, batch: int):
    """dp mesh for the streaming serving program when -num_chips > 1 and
    the camera batch divides evenly; None otherwise (single-chip).  The
    reference's multi-video loop is single-GPU (yolo_core.cpp:276-392)."""
    n = getattr(args, "num_chips", 1)
    if n <= 1 or batch % n:
        return None
    mesh = getattr(args, "_serve_mesh", None)
    if mesh is None:
        from darknet_tpu.parallel import make_mesh

        mesh = make_mesh(n)
        args._serve_mesh = mesh
    return mesh


def _device_letterbox(net, frames_u8):
    """Shared on-device letterbox: (N,H,W,C) uint8 RGB frames -> device
    f32 [0,1] letterboxed batch; the compiled program is cached per input
    geometry on the Network."""
    from darknet_tpu.data.image import make_letterbox_device

    _n, ih, iw, _c = frames_u8.shape
    key = ("_lbx", ih, iw, net.net.w, net.net.h)
    cache = getattr(net, "_lbx_cache", None)
    if cache is None:
        cache = net._lbx_cache = {}
    fn = cache.get(key)
    if fn is None:
        # insert (don't replace the dict): alternating input geometries
        # on one Network must not evict each other's compiled programs
        fn = cache[key] = make_letterbox_device(
            ih, iw, net.net.w, net.net.h, frames_u8.shape[3])
    return fn(frames_u8)


def _submit_frame(net, frame_bgr, args):
    """Streaming half 1: launch the device serving program for one frame
    WITHOUT blocking (JAX async dispatch) — the next frame's preprocess
    and the previous frame's draw/track/write overlap the device time.
    Device-postprocess path only.

    Frames travel host->device as RAW uint8 (1/4 the bytes of the f32
    frame) and normalize on device; with -letter_box the resize itself moves on device too, so
    the upload is the camera-native frame."""
    import cv2

    if getattr(args, "letter_box", False):
        x = _device_letterbox(net, np.ascontiguousarray(
            frame_bgr[None, ..., ::-1]))
    else:
        rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
        # uint8 resize (SIMD fixed-point) matches the f32 resize to
        # interpolation-rounding tolerance; the accuracy-parity modes
        # (image/valid) keep the f32 host path
        x = cv2.resize(rgb, (net.net.w, net.net.h),
                       interpolation=cv2.INTER_LINEAR)[None]
    return net.submit_detect_device(x, thresh=args.thresh,
                                    nms=args.nms_thresh,
                                    top_k=getattr(args, "top_k", 256))


def _finalize_frame(net, md, frame_bgr, out, args, track_manager=None):
    """Streaming half 2: materialize a _submit_frame result and run the
    shared host tail (letterbox correction, most-prob, track, draw)."""
    dets = net.device_out_to_dets(*out)[0]
    return _host_tail(net, md, frame_bgr, dets, args, track_manager)


def _proc_frames_batch(net, md, frames_bgr, args, track_managers=None):
    """Batched ProcImage for N cameras: ONE network predict per frame set.

    Upgrades the reference's multi-video loop (yolo_core.cpp:276-392),
    which pushes each camera's frame through the network sequentially at
    batch=1; here all N frames ride one batch dimension (one executable,
    one H2D/D2H round trip per frame set).
    """
    sub = _submit_frames_batch(net, frames_bgr, args)
    return _finalize_frames_batch(net, md, frames_bgr, sub, args,
                                  track_managers)


def _submit_frames_batch(net, frames_bgr, args):
    """Streaming half 1 for N cameras: preprocess + launch the batched
    device program without blocking (device path); the host path has no
    async boundary and resolves synchronously."""
    import cv2

    letter = getattr(args, "letter_box", False)
    shapes = {f.shape for f in frames_bgr}
    if letter and len(shapes) == 1:
        # all cameras share a resolution: letterbox ON DEVICE (the host
        # CPU resize is the multi-camera bottleneck); BGR->RGB is a
        # device-side channel flip.  The result stays ON DEVICE:
        # np.asarray here would block on the letterbox program + D2H and
        # re-upload for the detect program, stalling the depth-1
        # pipeline with two extra transfers
        x = _device_letterbox(net, np.stack(frames_bgr)[..., ::-1])
    elif not letter and _use_device_nms(args):
        # device path: uint8 resize + raw uint8 batch upload (1/4 the
        # H2D bytes of f32); the serving program normalizes on device
        # (see _submit_frame)
        x = np.stack([
            cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB),
                       (net.net.w, net.net.h),
                       interpolation=cv2.INTER_LINEAR)
            for f in frames_bgr])
    else:
        xs = []
        for frame in frames_bgr:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(
                np.float32) / 255.0
            if letter:
                from darknet_tpu.data.image import letterbox_image

                xs.append(letterbox_image(rgb, net.net.w, net.net.h))
            else:
                xs.append(cv2.resize(rgb, (net.net.w, net.net.h),
                                     interpolation=cv2.INTER_LINEAR))
        x = np.stack(xs)
    if _use_device_nms(args):
        # submit_detect_device passes device arrays (the on-device
        # letterbox output) straight through to the detect program
        return ("dev", net.submit_detect_device(
            x, thresh=args.thresh, nms=args.nms_thresh,
            top_k=getattr(args, "top_k", 256),
            mesh=_serving_mesh(args, x.shape[0])))
    return ("host", net.detect_batch(np.asarray(x), thresh=args.thresh,
                                     nms=args.nms_thresh,
                                     mesh=_serving_mesh(args,
                                                        len(frames_bgr))))


def _finalize_frames_batch(net, md, frames_bgr, sub, args,
                           track_managers=None):
    """Streaming half 2 for N cameras: materialize + shared host tail."""
    kind, payload = sub
    dets_b = (net.device_out_to_dets(*payload) if kind == "dev"
              else payload)
    return [
        _host_tail(net, md, frame, dets, args,
                   track_managers[i] if track_managers else None)
        for i, (frame, dets) in enumerate(zip(frames_bgr, dets_b))
    ]


def mode_train(args):
    from darknet_tpu.train.trainer import DetectorTrainer

    md = _load_metadata(args)
    train_paths = md.load_paths("train")
    val_paths = md.load_paths("valid") if (args.calc_map and md.valid_list) \
        else []
    mesh = None
    if args.num_chips > 1:
        from darknet_tpu.parallel import make_mesh

        mesh = make_mesh(args.num_chips)
    with open(args.model_file) as f:
        cfg_text = f.read()
    trainer = DetectorTrainer(
        cfg_text, train_paths,
        weights=args.weights_file if os.path.exists(args.weights_file)
        else None,
        classes=md.classes, clear=args.clear, mesh=mesh,
        calc_map=args.calc_map and bool(val_paths), val_paths=val_paths,
        save_dir=md.backup_dir,
        save_name=os.path.splitext(os.path.basename(args.model_file))[0],
        metrics_path=args.metrics_file or None,
        show_imgs=3 if args.show_imgs else 0, remat=args.remat,
        act16=True if args.act16 else (False if args.no_act16 else None),
        loader_processes=args.loader_processes, resume=args.resume,
        metric_lag=None if args.metric_lag < 0 else args.metric_lag)
    print(trainer.graph.layer_table(), file=sys.stderr)
    trainer.train()


def mode_valid(args):
    from darknet_tpu.eval.map import validate_detector

    md = _load_metadata(args)
    net = _load_network(args)
    if args.benchmark_layers:
        # -benchmark_layers (network_kernels.cu:46-114): profiler-trace
        # per-layer report
        import numpy as _np

        import jax.numpy as _jnp

        from darknet_tpu.nn.emit import make_forward
        from darknet_tpu.utils.profiler import trace_report

        fwd = make_forward(net.graph, compute_dtype=net.compute_dtype,
                           fused_bn=net.fused)
        xb = _jnp.asarray(_np.random.default_rng(0).uniform(
            0, 1, (1, net.net.h, net.net.w, net.net.c)
        ).astype(_np.float32))

        def _probe(p, x):
            # consume EVERY head (not just the last layer's output) so XLA
            # can't dead-code-eliminate the other detection branches —
            # the profiled program must be the full serving graph
            r = fwd(p, x)
            outs = r["heads"] if r["heads"] else [r["output"]]
            return sum(_jnp.sum(o.astype(_jnp.float32)) for o in outs)

        trace_report(_probe, net.params, xb, graph=net.graph)
    paths = md.load_paths("valid")
    # (_load_network already applied -calib_file if it existed)
    if args.int8 and args.int8_calib and net._calib_absmax is None:
        # static activation scales from the first N real val images
        # (TensorRT-style calibration set)
        from darknet_tpu.data.image import (load_image_rgb,
                                            resize_image_darknet)

        calib = [resize_image_darknet(load_image_rgb(p),
                                      net.net.w, net.net.h)
                 for p in paths[:args.int8_calib]]
        net.calibrate_int8(calib)
        if args.calib_file:
            if net._calib_absmax is not None:
                net.save_calibration(args.calib_file)
            else:
                # calibrate_int8 no-ops when nothing was quantized (all
                # convs below the min_ch filter) — nothing to cache
                print("int8 calibration: no quantized convs, "
                      f"not writing {args.calib_file}", file=sys.stderr)
    mesh = None
    batch = 8 if len(paths) >= 8 else 1
    if args.num_chips > 1:
        # multi-chip valid: batch-sharded forward, host decode/NMS/PR
        # unchanged (the reference's ValidateDetector is single-GPU)
        from darknet_tpu.parallel import make_mesh
        from darknet_tpu.parallel.mesh import round_batch_to_mesh

        mesh = make_mesh(args.num_chips)
        batch = round_batch_to_mesh(batch, args.num_chips)
    # the reference's valid mode resizes with its own two-pass bilinear
    # (load_image + resize_image, data.cpp:695-698) — use the exact port
    # so CLI mAP numbers are comparable with the reference binary's
    from darknet_tpu.eval.map import COCO_IOUS

    res = validate_detector(net, paths, md.classes, iou_thresh=0.5,
                            batch=batch, resize="darknet", mesh=mesh,
                            iou_thresholds=(COCO_IOUS if args.coco_map
                                            else None))
    print(f"\n # of pred: {res.n_pred}\n # of GT: {res.n_gt}")
    print(f" Recall: {res.recall:.4g}%\n Precision: {res.precision:.4g}%")
    for cid, ap in enumerate(res.per_class_ap):
        print(f" cid = {cid}, name = {md.names[cid]}, ap = {ap * 100:.4g}%")
    print(f"\n mAP@0.5: {res.map * 100:.4g}%")
    if res.map_mean_iou is not None:
        print(f" AP@[.5:.95]: {res.map_mean_iou * 100:.4g}%")
    print(f" Total prediction time: {res.pred_time_s:.4g}s")
    print(f" Prediction per second: {res.imgs_per_s:.4g}")
    return res.map


def mode_image(args):
    import cv2

    md = _load_metadata(args)
    net = _load_network(args)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.input_file.split(","):
        if not path:
            continue
        frame = cv2.imread(path)
        if frame is None:
            print(f"could not read {path}", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        display, dets = _proc_frame(net, md, frame, args)
        dt = (time.perf_counter() - t0) * 1000
        print(f"{path}: {len(dets)} objects, {dt:.1f} ms")
        for d in dets:
            print(f"  {md.names[d.cid]}: {d.prob * 100:.0f}%")
        out = os.path.join(args.out_dir,
                           "det_" + os.path.basename(path))
        cv2.imwrite(out, display)
        print(f"  saved {out}")
        from darknet_tpu.apps import visualize as _viz

        _viz.safe_imshow(args.mode, display, wait_ms=0)  # yolo_core.cpp:211


def mode_video(args):
    import cv2

    from darknet_tpu.apps import visualize as viz
    from darknet_tpu.apps.tracker import ConfParam, TrackManager

    md = _load_metadata(args)
    net = _load_network(args)
    path = args.input_file.split(",")[0]
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        print(f"could not open {path}", file=sys.stderr)
        return
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    max_frame = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    tm = None
    if not args.disable_tracking:
        tm = TrackManager(ConfParam.from_fps(fps), fps, 0.3)

    # frame prefetch thread: decode the next frame while the device computes
    # (the reference's loader-pool/double-buffer idea applied to streaming)
    import queue
    import threading

    frames_q: "queue.Queue" = queue.Queue(maxsize=4)
    stop_evt = threading.Event()          # set by ESC in the live window

    def _reader():
        while not stop_evt.is_set():
            ok, f = cap.read()
            if not ok:
                break
            frames_q.put(f)
        frames_q.put(None)

    reader_t = threading.Thread(target=_reader, daemon=True)
    reader_t.start()

    writer = None
    curr = 0
    gui = _gui_ok()

    def _emit(display, dt):
        nonlocal writer, curr
        rgb = cv2.cvtColor(display, cv2.COLOR_BGR2RGB)
        viz.draw_proc_time(rgb, dt)
        viz.draw_frame_info(rgb, curr, max_frame)
        out_bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        if args.save_output:
            if writer is None:
                os.makedirs(args.out_dir, exist_ok=True)
                out = os.path.join(
                    args.out_dir,
                    os.path.splitext(os.path.basename(path))[0] + "_out.mp4")
                writer = cv2.VideoWriter(
                    out, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                    (out_bgr.shape[1], out_bgr.shape[0]))
            writer.write(out_bgr)
        if gui:
            # yolo_core.cpp:267-268; ESC stops the stream
            if viz.safe_imshow(args.mode, out_bgr) == 27:
                stop_evt.set()
        curr += 1

    if _use_device_nms(args):
        # depth-N streaming pipeline (-pipeline_depth, default 2):
        # submit up to N frames' device programs before materializing
        # the oldest — the device computes while the host draws, tracks
        # and writes, and at depth>=2 the device never drains while the
        # host tail runs (results stay strictly in order, so tracking
        # semantics are unchanged; the reference processes each frame
        # start-to-finish sequentially, yolo_core.cpp:219-274)
        from collections import deque

        depth = max(1, getattr(args, "pipeline_depth", 2))
        pending: "deque" = deque()   # (frame, device-output, submit-secs)
        eof = False
        while True:
            if not eof:
                frame = frames_q.get()
                if stop_evt.is_set():
                    frame = None           # ESC: finalize pending and stop
                if frame is None:
                    eof = True
                else:
                    t0 = time.perf_counter()
                    out = _submit_frame(net, frame, args)
                    pending.append((frame, out,
                                    time.perf_counter() - t0))
            while pending and (eof or len(pending) > depth):
                pframe, pout, sub_dt = pending.popleft()
                # proc time = submit (preprocess+dispatch) + finalize
                # (residual device wait + host tail) — NOT the gap since
                # submission, which would include waiting on the frame
                # SOURCE for frame N+1 (a 1 fps camera would read ~1000 ms)
                t0 = time.perf_counter()
                display, _ = _finalize_frame(net, md, pframe, pout, args,
                                             track_manager=tm)
                _emit(display,
                      (sub_dt + time.perf_counter() - t0) * 1000)
            if eof and not pending:
                break
    else:
        while True:
            frame = frames_q.get()
            if frame is None or stop_evt.is_set():
                break
            t0 = time.perf_counter()
            display, _ = _proc_frame(net, md, frame, args, track_manager=tm)
            _emit(display, (time.perf_counter() - t0) * 1000)
    # on ESC the reader may still be alive (possibly blocked on a full
    # queue): signal it, drain, and only release the capture once the
    # reader is done — cv2.VideoCapture is not safe for concurrent
    # read()/release()
    stop_evt.set()
    while True:
        try:
            frames_q.get_nowait()
        except queue.Empty:
            break
    reader_t.join(timeout=2.0)
    if not reader_t.is_alive():
        cap.release()
    if writer is not None:
        writer.release()
    print(f"processed {curr} frames")


def mode_multi_video(args):
    """N cameras, N trackers, handover crosstalk between two cameras' zones
    (yolo_core.cpp:276-392): frames processed sequentially through ONE
    network."""
    import cv2

    from darknet_tpu.apps.geo import GeoInfo, Handover
    from darknet_tpu.apps.tracker import ConfParam, TrackManager

    md = _load_metadata(args)
    net = _load_network(args)
    files = [f for f in args.input_file.split(",") if f]
    caps = [cv2.VideoCapture(f) for f in files]
    fps = caps[0].get(cv2.CAP_PROP_FPS) or 30.0 if caps else 30.0
    tms = [TrackManager(ConfParam.from_fps(fps), fps, 0.3) for _ in files]
    geos = []
    for f in files:
        g = GeoInfo()
        xml = args.geo_info_file or os.path.splitext(f)[0] + ".xml"
        if os.path.exists(xml):
            g.load(xml, fps=fps)
        geos.append(g)

    writers = [None] * len(files)
    curr = 0

    def _read_set():
        frames = []
        for cap in caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frames.append(frame)
        return frames

    gui = _gui_ok()
    stop = False
    max_frame = int(caps[0].get(cv2.CAP_PROP_FRAME_COUNT)) if caps else 0

    def _tail(outs, proc_ms):
        nonlocal curr, stop
        from darknet_tpu.apps import visualize as _viz

        for i, (display, _dets) in enumerate(outs):
            geos[i].proc(tms[i].get_tracks())
            # zone overlay per camera (yolo_core.cpp:351-352): polygons +
            # parking occupancy HH:MM:SS; display frames are BGR here
            geos[i].draw(display, bgr=True)
            # proc time + frame counter (yolo_core.cpp:374-375 draws them
            # on the concatenated display; we keep per-camera windows, so
            # overlay on each) — text colors are symmetric white/red-in-
            # channel-terms only for white; draw on an RGB view
            rgb = cv2.cvtColor(display, cv2.COLOR_BGR2RGB)
            _viz.draw_proc_time(rgb, proc_ms)
            _viz.draw_frame_info(rgb, curr, max_frame)
            display[:] = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
            if args.save_output:
                if writers[i] is None:
                    os.makedirs(args.out_dir, exist_ok=True)
                    out = os.path.join(
                        args.out_dir,
                        os.path.splitext(os.path.basename(files[i]))[0]
                        + "_out.mp4")
                    writers[i] = cv2.VideoWriter(
                        out, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (display.shape[1], display.shape[0]))
                writers[i].write(display)
            if gui:
                # one window per camera (yolo_core.cpp:378-379); ESC from
                # any window stops all streams
                from darknet_tpu.apps import visualize as _viz

                if _viz.safe_imshow(f"{args.mode}-{i}", display) == 27:
                    stop = True
        # cross-camera label handover between the first two cameras' zones
        if len(geos) >= 2 and geos[0].handovers and geos[1].handovers:
            Handover.crosstalk(geos[0].handovers[0], geos[1].handovers[0])
        curr += 1

    if _use_device_nms(args):
        # depth-N streaming pipeline across frame sets (see mode_video):
        # up to -pipeline_depth sets' device programs run while this
        # set's geo/track/write tail executes on host; set order is
        # preserved
        from collections import deque

        depth = max(1, getattr(args, "pipeline_depth", 2))
        pending: "deque" = deque()
        eof = False
        while True:
            if not eof:
                frames = None if stop else _read_set()
                if frames is None:
                    eof = True
                else:
                    t0 = time.perf_counter()
                    pending.append(
                        (frames, _submit_frames_batch(net, frames, args),
                         time.perf_counter() - t0))
            while pending and (eof or len(pending) > depth):
                pframes, psub, sub_dt = pending.popleft()
                t0 = time.perf_counter()
                outs = _finalize_frames_batch(net, md, pframes, psub, args,
                                              track_managers=tms)
                _tail(outs, (sub_dt + time.perf_counter() - t0) * 1000)
            if eof and not pending:
                break
    else:
        while True:
            frames = _read_set()
            if frames is None or stop:
                break
            t0 = time.perf_counter()
            outs = _proc_frames_batch(net, md, frames, args,
                                      track_managers=tms)
            _tail(outs, (time.perf_counter() - t0) * 1000)
    for cap in caps:
        cap.release()
    for wr in writers:
        if wr is not None:
            wr.release()
    print(f"processed {curr} frames from {len(files)} cameras")


def main(argv=None):
    from darknet_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import contextlib

    args = build_parser().parse_args(argv)
    if getattr(args, "latency", False):
        # low-latency preset: top_k=64 trims the D2H payload and the
        # NMS rank predicate, depth 1 returns the freshest frame
        parser = build_parser()
        if args.top_k == parser.get_default("top_k"):
            args.top_k = 64
        args.pipeline_depth = 1
    with contextlib.ExitStack() as stack:
        if args.dbg_sync:
            # -cuda_dbg_sync analogue (dark_cuda.h:9): synchronous dispatch
            # + NaN fail-fast so failures surface at the faulting op;
            # restored deterministically when the mode returns
            from darknet_tpu.utils import debug as dbg

            stack.enter_context(dbg.debug_sync_mode())
            if args.dbg_sync >= 2:
                stack.enter_context(dbg.debug_nans())
        if args.mode == "train":
            mode_train(args)
        elif args.mode == "valid":
            # do NOT return the mAP float: the console script wraps main
            # in sys.exit(), and a non-int exit value means status 1 —
            # every successful validation would "fail" in scripts
            mode_valid(args)
        elif args.mode == "image":
            mode_image(args)
        elif args.mode == "video":
            mode_video(args)
        elif args.mode == "multi-video":
            mode_multi_video(args)
        elif args.mode == "bench":
            import bench

            bench.main()


if __name__ == "__main__":
    main()
