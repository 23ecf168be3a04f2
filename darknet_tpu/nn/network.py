"""Network facade: the public API mirroring `yolo_core.h:625-663`.

    net = Network.from_cfg("yolov4.cfg", weights="yolov4.weights")
    dets = net.detect(image, thresh=0.25, nms=0.45)

`from_cfg` = LoadNetwork (parse + load weights + fuse BN for inference);
`predict` = NetworkPredict (jitted forward, cached per input shape);
`detect`  = NetworkPredict + GetNetworkBoxes + NmsSort + threshold;
`save_weights` = SaveWeights.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import Graph, build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.nn.emit import make_forward
from darknet_tpu.ops import nms as nmslib
from darknet_tpu.ops import yolo as yoloops
from darknet_tpu.weights import io as wio


@dataclasses.dataclass
class Detection:
    """Mirror of the reference `Detection` struct (box.h:68-85): bbox in
    relative center-format, per-class probs, objectness, optional gaussian
    uncertainties."""

    bbox: tuple                 # (x, y, w, h) relative center-format
    objectness: float
    prob: np.ndarray            # (classes,)
    uc: np.ndarray | None = None  # (4,) gaussian sigmas

    @property
    def best_class(self) -> int:
        return int(np.argmax(self.prob))

    @property
    def best_prob(self) -> float:
        return float(self.prob[self.best_class])


def detections_to_json(dets: list, frame_id: int = 0,
                       names: list | None = None,
                       filename: str | None = None) -> str:
    """Detection2Json (network.cpp:531-593): classes named `dont_show*`
    are skipped and the filename rides in the header when given."""
    objects = []
    for d in dets:
        for j in np.nonzero(d.prob > 0)[0]:
            name = (str(names[j]) if names and j < len(names)
                    else str(int(j)))
            if name.startswith("dont_show"):
                continue                       # network.cpp:556-558
            x, y, w, h = d.bbox
            objects.append({
                "class_id": int(j),
                "name": name,
                "relative_coordinates": {
                    "center_x": float(x), "center_y": float(y),
                    "width": float(w), "height": float(h),
                },
                "confidence": float(d.prob[j]),
            })
    out: dict = {"frame_id": frame_id}
    if filename is not None:
        out["filename"] = filename             # network.cpp:542-545
    out["objects"] = objects
    return json.dumps(out, indent=1)


class Network:
    def __init__(self, graph: Graph, params: list, *, fused: bool = False,
                 train: bool = False, compute_dtype=None, seen: int = 0):
        self.graph = graph
        self.net = graph.net
        self.params = params
        self.fused = fused
        self.train = train
        self.compute_dtype = compute_dtype
        self.seen = seen
        self._fwd_cache: dict = {}
        self._calib_absmax: dict | None = None

    # ---------------------------------------------------------------- load
    @classmethod
    def from_cfg(cls, cfg, weights=None, *, train: bool = False,
                 clear: bool = False, fuse: bool | None = None,
                 compute_dtype=None, seed: int = 0,
                 int8: bool = False) -> "Network":
        """LoadNetwork (parser.cpp:1852-1876): parse cfg, load weights,
        fuse conv+BN when not training.  int8=True additionally quantizes
        eligible convs for the low-precision inference path (the XNOR
        analogue; see ops/conv.conv_block_int8)."""
        graph = build_graph(cfg, train=train)
        seen = 0
        if weights is not None:
            params, seen, _version = wio.load_weights(graph, weights)
            # fill any layers the file didn't cover (partial backbones)
            init = paramlib.init_params(graph, seed=seed)
            params = [p if p else ip for p, ip in zip(params, init)]
        else:
            params = paramlib.init_params(graph, seed=seed)
        if fuse is None:
            fuse = not train
        fused = False
        if fuse:
            params = paramlib.fuse_conv_batchnorm(graph, params)
            fused = True
        if int8:
            assert fused and not train, "int8 is an inference mode"
            params = paramlib.quantize_conv_params(graph, params)
        if clear:
            seen = 0
        net = cls(graph, params, fused=fused, train=train,
                  compute_dtype=compute_dtype, seen=seen)
        try:
            if isinstance(cfg, str) and "\n" in cfg:
                net._cfg_text = cfg
            else:
                with open(cfg, "r") as f:
                    net._cfg_text = f.read()
        except OSError:
            net._cfg_text = None
        return net

    def calibrate_int8(self, images) -> None:
        """Static int8 activation calibration (TensorRT-style): record each
        quantized conv's input range over `images` (iterable of HWC or BHWC
        float arrays, network-sized) and bake per-tensor scales so serving
        skips the per-conv dynamic absmax reduce
        (ops/conv.conv_block_int8).  Convs feeding detection heads stay
        full-precision."""
        if not any("w_q" in p for p in self.params):
            # nothing quantized (int8=False, or no eligible convs) — no-op
            return
        batches = []
        for im in images:
            a = np.asarray(im, dtype=np.float32)
            batches.append(a[None] if a.ndim == 3 else a)
        absmax = paramlib.calibrate_conv_input_scales(
            self.graph, self.params, batches,
            compute_dtype=self.compute_dtype)
        self._apply_calibration(absmax)

    def save_calibration(self, path) -> None:
        """Persist the calibrated per-conv input ranges (the TensorRT
        'calibration cache' analogue): calibrate once on a real image
        set, then serve many times via load_calibration without paying
        the calibration forward passes."""
        if self._calib_absmax is None:
            raise ValueError("no calibration to save: run calibrate_int8 "
                             "first")
        # write through a file object: np.savez(path) silently appends
        # ".npz" to bare paths, so a `-calib_file scales.cache` would
        # never round-trip through load_calibration
        with open(path, "wb") as f:
            np.savez(f, **{str(k): np.asarray(v, np.float32)
                           for k, v in self._calib_absmax.items()})

    def load_calibration(self, path) -> None:
        """Apply input scales previously saved by save_calibration."""
        data = np.load(path)
        absmax = {int(k): float(data[k]) for k in data.files}
        self._apply_calibration(absmax)

    def _apply_calibration(self, absmax: dict) -> None:
        self._calib_absmax = dict(absmax)
        self.params = paramlib.apply_conv_input_scales(
            self.params, absmax, graph=self.graph)
        self._fwd_cache.clear()

    @property
    def curr_iter(self) -> int:
        return self.seen // max(self.net.optimizer_batch, 1)

    # ------------------------------------------------------------- forward
    def _device_detect_fn(self, batch: int, h: int, w: int, thresh: float,
                          nms: float, top_k: int, score_dtype=None,
                          mesh=None):
        """Fully on-device postprocess: decode -> obj threshold -> top-k ->
        masked NMS.  Only (top_k) detections per image leave HBM — the
        design goal of BASELINE.json's north star.

        score_dtype (e.g. bf16) selects the serving score precision for
        decode outputs (ops/yolo.yolo_decode); default f32 keeps
        bit-parity with the host path.  bench.py measures this exact
        function.

        mesh: a `jax.sharding.Mesh` scales SERVING across cards — the
        batch axis shards over its "dp" axis (and feature-map H over an
        optional "sp" axis, halo exchanges inserted by GSPMD exactly as
        in parallel/spatial.py); params replicate, outputs stay
        batch-sharded so each card's top-k detections transfer from its
        own HBM.  The reference has no multi-GPU inference at all
        (ValidateDetector/ProcImage are single-device,
        detector.cpp:326/yolo_core.cpp:104) — this is the serving
        scale-out."""
        key = ("dev", batch, h, w, thresh, nms, top_k, score_dtype, mesh)
        if key not in self._fwd_cache:
            fwd = make_forward(self.graph, train=False,
                               compute_dtype=self.compute_dtype,
                               fused_bn=self.fused)
            net_w, net_h = self.net.w, self.net.h
            heads = [l for l in self.graph.heads()
                     if l.kind in ("yolo", "gaussian_yolo")]
            kind = heads[0].nms_kind if heads else "greedynms"
            beta = heads[0].beta_nms if heads else 0.6

            def run(params, x):
                if x.dtype == jnp.uint8:
                    # low-latency ingest: frames upload as raw uint8 (4x
                    # less H2D traffic than f32) and normalize on device.
                    # XLA lowers /255 to reciprocal-multiply, so values
                    # match _prep_input's host divide to 1 ulp (not
                    # bit-exactly) — immaterial for uint8 camera data,
                    # but the accuracy-parity paths keep host f32 input
                    x = x.astype(jnp.float32) / 255.0
                r = fwd(params, x)
                boxes_l, obj_l, cls_l = [], [], []
                for t, l in zip(r["heads"], heads):
                    t = t.astype(jnp.float32)
                    # native order: candidate ordering is immaterial ahead
                    # of top-k, and reference order costs ~100MB of
                    # transposes per 608² batch
                    if l.kind == "yolo":
                        b, o, c = yoloops.yolo_decode(
                            t, l, net_w, net_h, order="native",
                            score_dtype=score_dtype)
                    else:
                        b, o, c, _u = yoloops.gaussian_yolo_decode(
                            t, l, net_w, net_h, order="native",
                            score_dtype=score_dtype)
                    boxes_l.append(b)
                    obj_l.append(o)
                    cls_l.append(c)
                boxes = jnp.concatenate(boxes_l, axis=1)
                obj = jnp.concatenate(obj_l, axis=1)
                cls = jnp.concatenate(cls_l, axis=1)

                obj = jnp.where(obj > thresh, obj, 0.0)
                k = min(top_k, obj.shape[1])
                ov, idx = jax.lax.top_k(obj, k)
                tb = jnp.take_along_axis(boxes, idx[..., None], axis=1)
                tc = jnp.take_along_axis(cls, idx[..., None], axis=1)
                probs = ov[..., None] * tc
                probs = jnp.where(probs > thresh, probs, 0.0)

                if nms > 0:
                    probs = jax.vmap(
                        lambda b, p: nmslib.nms_device(b, p, nms, kind=kind,
                                                       beta=beta)
                    )(tb, probs)
                return tb, ov, probs

            if mesh is None:
                self._fwd_cache[key] = jax.jit(run)
            else:
                from jax.sharding import NamedSharding, PartitionSpec as P

                x_sh, rep = self._serve_shardings(mesh, batch)
                out_sh = NamedSharding(mesh, P("dp"))
                self._fwd_cache[key] = jax.jit(
                    run, in_shardings=(rep, x_sh),
                    out_shardings=(out_sh, out_sh, out_sh))
        return self._fwd_cache[key]

    def export_serving(self, path, *, batch: int = 1, thresh: float = 0.25,
                       nms: float = 0.45, top_k: int = 256,
                       score_dtype=None) -> None:
        """Serialize the complete serving program — forward + decode +
        top-k + device NMS with the weights baked in as constants — to a
        portable `jax.export` artifact (StableHLO): the analogue of a
        TensorRT engine.  Deploy the one file and run it
        with `run_exported_serving`; neither the cfg, the weights, nor
        the graph builder are needed at serving time.  The artifact is
        specialized to (batch, net dims, thresholds) and to the
        platform it was exported on (CUDA on a GPU host)."""
        from jax import export as jexport

        fn = self._device_detect_fn(batch, self.net.h, self.net.w,
                                    thresh, nms, top_k, score_dtype)
        params = self.params

        exp = jexport.export(jax.jit(lambda x: fn(params, x)))(
            jax.ShapeDtypeStruct((batch, self.net.h, self.net.w,
                                  self.net.c), jnp.float32))
        with open(path, "wb") as f:
            f.write(exp.serialize())

    @staticmethod
    def run_exported_serving(path, x):
        """Run an export_serving artifact: returns the device-detect
        triple (boxes (B,K,4), objectness (B,K), probs (B,K,classes))."""
        from jax import export as jexport

        with open(path, "rb") as f:
            exp = jexport.deserialize(f.read())
        return exp.call(jnp.asarray(x, dtype=jnp.float32))

    def detect_batch_device(self, images, thresh: float = 0.25,
                            nms: float = 0.45, top_k: int = 256,
                            mesh=None) -> list:
        """Production path: device-side postprocess, host only receives the
        final top_k candidates per image.  With `mesh`, the batch shards
        over the mesh's "dp" axis (multi-chip serving; see
        _device_detect_fn)."""
        return self.device_out_to_dets(
            *self.submit_detect_device(images, thresh=thresh, nms=nms,
                                       top_k=top_k, mesh=mesh))

    def submit_detect_device(self, images, thresh: float = 0.25,
                             nms: float = 0.45, top_k: int = 256,
                             mesh=None, score_dtype=None):
        """Dispatch the device serving program WITHOUT materializing the
        result: returns the (boxes, objectness, probs) device triple —
        JAX async dispatch means the call returns as soon as the program
        is enqueued.  Streaming callers submit frame t+1, then finalize
        frame t with `device_out_to_dets` while t+1 runs on device (the
        CLI video modes and examples/04 use exactly this pattern).

        Device-resident inputs (e.g. the on-device letterbox output)
        pass through with a shape check only — np.asarray here would be
        a blocking D2H + re-upload, defeating the async submit."""
        if isinstance(images, jax.Array):
            x = images if images.ndim == 4 else images[None]
            if x.shape[1:] != (self.net.h, self.net.w, self.net.c):
                raise ValueError(
                    f"input must be (H,W,C)=({self.net.h},{self.net.w},"
                    f"{self.net.c}) — got {x.shape[1:]}")
        elif getattr(images, "dtype", None) == np.uint8:
            # raw uint8 frames upload as-is (1/4 the H2D bytes of f32);
            # the serving program normalizes on device — matches the
            # host astype/255 to 1 ulp (see _device_detect_fn)
            x = np.asarray(images)
            if x.ndim == 3:
                x = x[None]
            if x.shape[1:] != (self.net.h, self.net.w, self.net.c):
                raise ValueError(
                    f"input must be (H,W,C)=({self.net.h},{self.net.w},"
                    f"{self.net.c}) — got {x.shape[1:]}")
        else:
            x = self._prep_input(images)
        fn = self._device_detect_fn(x.shape[0], x.shape[1], x.shape[2],
                                    thresh, nms, top_k, mesh=mesh,
                                    score_dtype=score_dtype)
        return fn(self.params, x)

    @staticmethod
    def device_out_to_dets(tb, ov, probs) -> list:
        """Materialize a device-detect triple (boxes, objectness, probs)
        into per-image Detection lists — the host-side tail of
        detect_batch_device, split out so streaming callers can overlap
        the device program with host work (JAX async dispatch) and
        finalize later."""
        tb = np.asarray(tb)
        ov = np.asarray(ov)
        probs = np.asarray(probs)
        results = []
        for b in range(tb.shape[0]):
            dets = []
            for i in range(tb.shape[1]):
                if ov[b, i] <= 0 or not np.any(probs[b, i] > 0):
                    continue
                dets.append(Detection(
                    bbox=tuple(float(v) for v in tb[b, i]),
                    objectness=float(ov[b, i]),
                    prob=probs[b, i]))
            results.append(dets)
        return results

    def _forward_fn(self, batch: int, h: int, w: int, mesh=None):
        key = (batch, h, w, self.train, mesh)
        if key not in self._fwd_cache:
            fwd = make_forward(
                self.graph, train=self.train,
                compute_dtype=self.compute_dtype, fused_bn=self.fused)
            net_w, net_h = self.net.w, self.net.h
            heads = self.graph.heads()

            def fwd_and_decode(params, x):
                r = fwd(params, x)
                decoded = []
                for t, l in zip(r["heads"], heads):
                    if l.kind == "yolo":
                        boxes, obj, cls = yoloops.yolo_decode(
                            t, l, net_w, net_h)
                        uc = None
                    elif l.kind == "gaussian_yolo":
                        boxes, obj, cls, uc = yoloops.gaussian_yolo_decode(
                            t, l, net_w, net_h)
                    else:
                        continue
                    decoded.append((boxes, obj, cls, uc))
                if decoded:
                    boxes = jnp.concatenate([d[0] for d in decoded], axis=1)
                    obj = jnp.concatenate([d[1] for d in decoded], axis=1)
                    cls = jnp.concatenate([d[2] for d in decoded], axis=1)
                    ucs = [d[3] for d in decoded]
                    if all(u is not None for u in ucs) and ucs:
                        uc = jnp.concatenate(ucs, axis=1)
                    else:
                        uc = None
                    return r["heads"], r["output"], (boxes, obj, cls, uc)
                return r["heads"], r["output"], None

            if mesh is None:
                self._fwd_cache[key] = jax.jit(fwd_and_decode)
            else:
                # batch-sharded forward for the host-NMS parity path —
                # every output (heads, final layer, decoded candidates)
                # keeps its leading batch dim sharded; replicating here
                # would all-gather the full head tensors per batch for
                # nothing (the host assembles sharded arrays fine)
                from jax.sharding import NamedSharding, PartitionSpec as P

                x_sh, _rep = self._serve_shardings(mesh, batch)
                self._fwd_cache[key] = jax.jit(
                    fwd_and_decode, in_shardings=(_rep, x_sh),
                    out_shardings=NamedSharding(mesh, P("dp")))
        return self._fwd_cache[key]

    @staticmethod
    def _serve_shardings(mesh, batch: int):
        """(input, replicated) NamedShardings for inference over `mesh`:
        batch shards on "dp", feature-map H on an optional "sp" axis."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = mesh.axis_names
        if "dp" not in axes:
            raise ValueError(f"serving mesh needs a 'dp' axis, got {axes}")
        n_dp = mesh.shape["dp"]
        if batch % n_dp:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"dp size {n_dp}")
        sp = "sp" if "sp" in axes else None
        return (NamedSharding(mesh, P("dp", sp, None, None)),
                NamedSharding(mesh, P()))

    def _prep_input(self, image) -> np.ndarray:
        # uint8 means raw [0,255] frames everywhere in the public API:
        # submit_detect_device normalizes /255 on device, so the host
        # paths (predict/detect/detect_batch) must apply the same
        # normalization or the two paths silently disagree on the same
        # image (advisor r4 finding)
        raw = np.asarray(image)
        if raw.dtype == np.uint8:
            x = raw.astype(np.float32) / 255.0
        else:
            x = np.asarray(raw, dtype=np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.shape[1:] != (self.net.h, self.net.w, self.net.c):
            raise ValueError(
                f"input must be (H,W,C)=({self.net.h},{self.net.w},"
                f"{self.net.c}) — got {x.shape[1:]}; resize first "
                f"(data.image.resize_image_cv) or rebuild the net at the "
                f"new resolution")
        return x

    def predict(self, image):
        """NetworkPredict: returns the final layer output (host numpy)."""
        x = self._prep_input(image)
        fn = self._forward_fn(*x.shape[:3])
        _heads, out, _dec = fn(self.params, x)
        return np.asarray(out)

    def forward_heads(self, image):
        x = self._prep_input(image)
        fn = self._forward_fn(*x.shape[:3])
        heads, _out, dec = fn(self.params, x)
        return [np.asarray(h) for h in heads], dec

    # ----------------------------------------------------------- detection
    def detect(self, image, thresh: float = 0.25, nms: float = 0.45,
               use_device_nms: bool = False) -> list:
        """GetNetworkBoxes + NmsSort: detections for ONE image (HWC input,
        already resized to net dims, RGB [0,1])."""
        x = self._prep_input(image)
        assert x.shape[0] == 1, "detect() is single-image; use detect_batch"
        return self.detect_batch(x, thresh=thresh, nms=nms,
                                 use_device_nms=use_device_nms)[0]

    def detect_batch(self, images, thresh: float = 0.25, nms: float = 0.45,
                     use_device_nms: bool = False, mesh=None) -> list:
        if use_device_nms:
            # full on-device postprocess (decode + top-k + NMS); top_k
            # bounds the per-image candidates unlike the host path
            return self.detect_batch_device(images, thresh=thresh, nms=nms,
                                            mesh=mesh)
        x = self._prep_input(images)
        fn = self._forward_fn(*x.shape[:3], mesh=mesh)
        _heads, _out, dec = fn(self.params, x)
        if dec is None:
            return [[] for _ in range(x.shape[0])]
        boxes, obj, cls, uc = dec
        boxes = np.asarray(boxes)
        obj = np.asarray(obj)
        cls = np.asarray(cls)
        uc = np.asarray(uc) if uc is not None else None

        # first head's nms config governs (reference uses l.nms_kind of each
        # head via GetNetworkBoxes -> the CLI passes the last head's kind;
        # in practice all heads share it)
        heads = [l for l in self.graph.heads()
                 if l.kind in ("yolo", "gaussian_yolo")]
        kind = heads[0].nms_kind if heads else "greedynms"
        beta = heads[0].beta_nms if heads else 0.6

        results = []
        for b in range(x.shape[0]):
            keep = obj[b] > thresh
            idx = np.nonzero(keep)[0]
            if idx.size == 0:
                results.append([])
                continue
            bb = boxes[b][idx]
            oo = obj[b][idx]
            # prob = obj * cls, thresholded (GetYoloDetections)
            pp = oo[:, None] * cls[b][idx]
            pp[pp <= thresh] = 0.0
            if nms > 0:
                pp = nmslib.nms_numpy(bb, pp, nms, kind=kind, beta=beta)
            dets = []
            for i in range(idx.size):
                if not np.any(pp[i] > 0):
                    continue
                dets.append(Detection(
                    bbox=tuple(float(v) for v in bb[i]),
                    objectness=float(oo[i]),
                    prob=pp[i],
                    uc=uc[b][idx][i] if uc is not None else None,
                ))
            results.append(dets)
        return results

    # ------------------------------------------------------------- resize
    def resize(self, w: int, h: int) -> "Network":
        """ResizeNetwork (network.cpp:255-410): rebuild the graph at a new
        input resolution.  Under XLA this is a re-jit — each (w, h) bucket
        compiles once and is cached; parameters carry over unchanged."""
        from darknet_tpu.config.cfg import patch_cfg_dims
        from darknet_tpu.graph.builder import build_graph

        if (w, h) == (self.net.w, self.net.h):
            return self
        # reparse the cfg dialect with patched dimensions: shapes re-derive
        # exactly like the reference's per-layer Resize* chain
        cfg = getattr(self, "_cfg_text", None)
        if cfg is None:
            raise ValueError("resize requires a Network built from a cfg")
        cfg = patch_cfg_dims(cfg, w, h)
        graph = build_graph(cfg, train=self.train)
        net2 = Network(graph, self.params, fused=self.fused,
                       train=self.train, compute_dtype=self.compute_dtype,
                       seen=self.seen)
        net2._cfg_text = cfg
        # static int8 calibration is per-conv, resolution-independent —
        # the baked scales already ride in params; carry the bookkeeping
        # so save_calibration keeps working after a resize
        net2._calib_absmax = self._calib_absmax
        return net2

    # ----------------------------------------------------------------- io
    def save_weights(self, path, cutoff: int | None = None) -> None:
        if self.fused:
            raise ValueError(
                "params have fused BN; reload with fuse=False to save")
        wio.save_weights(self.graph, self.params, path, seen=self.seen,
                         cutoff=cutoff)
