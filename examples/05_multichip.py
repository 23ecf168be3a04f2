"""Multi-chip data parallelism: sharded training step + sharded serving.

Forces an 8-device virtual CPU mesh (works on any machine; on a host with
several GPUs remove BOTH the XLA_FLAGS override below and the
`jax_platforms=cpu` update in main() and the same code runs over NVLink).
Demonstrates:

  * parallel.mesh.make_mesh + shard_batch — the device mesh and batch
    sharding (the replacement for the reference's
    pthread-per-GPU + PCIe weight averaging, network_kernels.cu:295-484);
  * parallel.dp.make_dp_train_step — ONE jitted program with the batch
    sharded over the `dp` axis; XLA inserts the gradient psum;
  * Network.detect_batch_device(mesh=...) — multi-chip serving: the
    full forward + decode + top-k + NMS program sharded over the batch.

See also parallel/tensor.py (filter sharding), parallel/spatial.py
(H-dim sharding for large inputs), parallel/pipeline.py (GPipe stages),
and parallel/multihost.py (multi-process DCN meshes).
"""

from __future__ import annotations

import os
import sys

# 8 virtual devices BEFORE jax initializes (real multi-chip: remove this)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(__file__))
from _common import base_parser, require_trained, workdir_paths  # noqa: E402


def main() -> None:
    ap = base_parser(__doc__)
    args = ap.parse_args()
    paths = workdir_paths(args.workdir)
    require_trained(paths)

    import jax

    jax.config.update("jax_platforms", "cpu")  # demo mesh on CPU devices
    import numpy as np

    from darknet_tpu.data import image as imlib
    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn.network import Network
    from darknet_tpu.parallel.dp import make_dp_train_step
    from darknet_tpu.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(8, axis="dp")
    print(f"mesh: {mesh}")

    # ---- sharded serving: one program, batch split over 8 devices ----
    net = Network.from_cfg(paths["cfg"], weights=paths["weights"])
    import glob

    img_paths = sorted(glob.glob(os.path.join(paths["dataset"],
                                              "va_*.png")))[:8]
    x = np.stack([imlib.resize_image_cv(imlib.load_image_rgb(p),
                                        net.net.w, net.net.h)
                  for p in img_paths])
    dets = net.detect_batch_device(x, mesh=mesh)
    print(f"sharded serving: {x.shape[0]} images -> "
          f"{sum(len(d) for d in dets)} detections "
          f"(batch sharded {x.shape[0] // 8}/device)")

    # ---- sharded training: per-step gradient psum over the mesh ----
    graph = build_graph(paths["cfg"], train=True)
    tnet = Network.from_cfg(paths["cfg"], weights=paths["weights"],
                            train=True, fuse=False)
    from darknet_tpu.train.step import init_opt_state

    step = make_dp_train_step(graph, mesh)
    opt = init_opt_state(graph, tnet.params)

    b = graph.net.batch
    rng = np.random.default_rng(0)
    xb = shard_batch(mesh, rng.random((b, graph.net.h, graph.net.w, 3),
                                      np.float32))
    # truths: (B, max_boxes, 5) [x, y, w, h, cls] relative — one box/img
    head = graph.heads()[-1]
    truths = np.zeros((b, head.max_boxes, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    truths = shard_batch(mesh, truths)

    params, opt, loss, _ = step(
        tnet.params, opt, xb, truths, jax.random.PRNGKey(0),
        np.float32(graph.net.lr))
    print(f"DP train step over {mesh.shape['dp']} devices: "
          f"loss = {float(loss):.3f}")
    print("gradients were psum-reduced inside the jitted step — "
          "no host round trips, no periodic weight averaging")


if __name__ == "__main__":
    main()
