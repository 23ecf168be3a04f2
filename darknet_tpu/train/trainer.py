"""Training orchestration — the TrainDetector equivalent
(detector.cpp:27-324).

Reproduced behaviours:
* ``max_iter = iter_per_epoch * max_epoch`` with
  ``iter_per_epoch = round(num_train_imgs / optimizer_batch)``
  (detector.cpp:79-85);
* multi-scale: every 10 iterations pick a random scale in
  [1/rand_coef, rand_coef] (rand_coef = 1.4 or the head's `random` value),
  snapped to `resize_step`; forced to max at the start and during the last
  100 iterations (detector.cpp:141-183).  Each (w, h) bucket is its own
  jitted executable, cached — the re-jit replaces ResizeNetwork;
* EMA avg-loss 0.9/0.1; periodic in-training mAP every
  ``map_step = max(100, iter_per_epoch)`` on held-out data, best-mAP
  checkpoint; checkpoints every 1000 iterations and at the end
  (detector.cpp:201-290);
* LR: burn-in warmup + policy schedule via GetCurrLr; `seen` advances by
  the optimizer batch per iteration;
* multi-chip: pass a mesh for per-step psum data parallelism (replaces
  TrainNetworks/SyncNetworks; lr is NOT auto-scaled — see parallel/dp.py).
"""

from __future__ import annotations

import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from darknet_tpu.data.loader import DetectionLoader
from darknet_tpu.defaults import platform_defaults
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.train.schedule import get_lr
from darknet_tpu.train.step import init_opt_state, make_train_step
from darknet_tpu.weights import io as wio


class DetectorTrainer:
    def __init__(self, cfg, train_paths, *, weights=None, classes=80,
                 clear=False, mesh=None, compute_dtype=None, seed=0,
                 calc_map=False, val_paths=None, save_dir="backup",
                 save_name="model", loader_threads=6, loader_processes=-1,
                 log=print, metrics_path=None, show_imgs=0, remat=False,
                 act16=None, full_state=True, resume=False,
                 metric_lag=None):
        self.graph = build_graph(cfg, train=True)
        self.net = self.graph.net
        # keep the cfg as TEXT so multi-scale rebuilds can patch dims
        if isinstance(cfg, str) and "\n" not in cfg:
            with open(cfg, "r") as f:
                self.cfg = f.read()
        else:
            self.cfg = cfg
        self.mesh = mesh
        # compute precision, act16 and metric_lag default per platform
        # (darknet_tpu/defaults.py): bf16 tensor-core operands with f32
        # accumulation on the GPU, f32 HIGHEST on the CPU so the golden
        # gates stay byte-stable.  Pass compute_dtype=jnp.float32 for
        # full-precision training on the card.
        dflt = platform_defaults()
        if compute_dtype is None:
            compute_dtype = dflt.compute_dtype
        self.compute_dtype = compute_dtype
        # rematerialize conv blocks in the backward pass (jax.checkpoint):
        # trades FLOPs for activation memory — the lever beyond
        # [net] subdivisions for 608^2 training on one card
        self.remat = remat
        # reduced-precision interlayer activations (train_act_dtype):
        # halves the vjp-residual traffic; BN stats stay f32
        if act16 is None:
            act16 = dflt.act16
        self.act16 = act16
        # async metrics pipeline: fetch iteration i's (loss, count, ...)
        # floats only once i+metric_lag has been DISPATCHED, keeping
        # `metric_lag` steps in flight instead of blocking on the device
        # every iteration.  Training math is untouched — LR, multi-scale
        # cadence, mAP cadence and checkpoints are all iteration-keyed,
        # and the queue is fully drained before any evaluate/save/resume
        # boundary — only the log line for iter i prints `metric_lag`
        # iterations later (the reference prints synchronously,
        # detector.cpp:255-266; deviation is display latency only).
        if metric_lag is None:
            metric_lag = dflt.metric_lag
        self.metric_lag = max(int(metric_lag), 0)
        self.log = log
        self.save_dir = save_dir
        self.save_name = save_name
        self.calc_map = calc_map
        self.val_paths = val_paths or []
        self.classes = classes

        self.seen = 0
        if weights is not None:
            params, self.seen, _ = wio.load_weights(self.graph, weights)
            init = paramlib.init_params(self.graph, seed=seed)
            self.params = [p if p else i for p, i in zip(params, init)]
        else:
            self.params = paramlib.init_params(self.graph, seed=seed)
        if clear:
            self.seen = 0

        # seed the update-gate iteration counter from seen so
        # dont_update/burnin_update thresholds survive a weights-only
        # resume (the reference derives it from seen, network.cpp:225-231)
        self.opt_state = init_opt_state(self.graph, self.params,
                                        iter0=self.curr_iter)

        # full-state checkpointing: alongside each periodic .weights the
        # trainer writes a rolling <save_name>_last.ckpt.npz carrying
        # params + optimizer slots + seen + rng — the reference loses
        # momentum on restart (SURVEY.md §5); resume=True restores it
        # (after the loader exists, so the data stream fast-forwards too)
        self.full_state = full_state
        self._key = jax.random.PRNGKey(0)
        self._avg_loss = -1.0        # EMA loss; persisted for exact resume
        self._best_map = 0.0         # best in-training mAP; persisted too
        self._dims = None            # current multi-scale bucket; persisted
        # loss/mAP chart history (DrawLossGraph, detector.cpp:123,269-270):
        # rendered to <save_dir>/chart.png (+ a live window when a display
        # exists); persisted so a resumed run's chart keeps its history —
        # the reference's chart restarts empty on every restart
        self._chart = {"iters": [], "losses": [], "map_iters": [],
                       "maps": []}
        self.state_path = os.path.join(save_dir,
                                       f"{save_name}_last.ckpt.npz")
        self._resume = resume

        heads = self.graph.heads()
        self.head = heads[-1] if heads else None
        self.max_boxes = getattr(self.head, "max_boxes", 90)
        self.jitter = getattr(self.head, "jitter", 0.3)
        self.random_coef = getattr(self.head, "random", 0.0)

        n_imgs = len(train_paths)
        self.iter_per_epoch = max(int(n_imgs / self.net.optimizer_batch + 0.5),
                                  1)
        self.net.max_iter = self.iter_per_epoch * max(self.net.max_epoch, 1)

        self.loader = DetectionLoader(
            train_paths, w=self.net.w, h=self.net.h,
            batch=self.net.optimizer_batch, boxes=self.max_boxes,
            classes=classes, jitter=self.jitter, hue=self.net.hue,
            saturation=self.net.saturation, exposure=self.net.exposure,
            flip=self.net.flip, blur=self.net.blur,
            gaussian_noise=self.net.gaussian_noise, mixup=self.net.mixup,
            threads=loader_threads, processes=self._auto_procs(
                loader_processes, loader_threads), seed=seed,
            show_imgs=show_imgs, show_imgs_dir=save_dir,
            out_dtype=self._loader_out_dtype())

        self._step_cache: dict = {}
        self._graph_cache: dict = {}

        from darknet_tpu.utils.metrics import MetricsLogger

        self.metrics = MetricsLogger(metrics_path, log=log)

        if self._resume:
            path = (self._resume if isinstance(self._resume, str)
                    else self.state_path)
            if not os.path.exists(path):
                # multi-process saves write a sharded DIRECTORY instead;
                # resolve_sharded_dir also recovers the .tmp/.old swap
                # siblings a crash mid-directory-swap can leave behind.
                # Keep the BASE dir name: load_checkpoint_sharded both
                # resolves the sibling AND promotes it back to the
                # primary name (so the next save can't destroy it).
                from darknet_tpu.train.checkpoint import resolve_sharded_dir

                alt = path[:-len(".npz")] if path.endswith(".npz") else path
                if resolve_sharded_dir(alt):
                    path = alt
                elif isinstance(self._resume, str):
                    raise FileNotFoundError(
                        f"resume checkpoint not found: {path}")
                else:
                    path = None            # -resume with nothing saved yet
            if path:
                self.load_state(path)

    @staticmethod
    def _auto_procs(loader_processes: int, loader_threads: int) -> int:
        """-1 = auto: spawn-based process workers on multi-core hosts
        (Python threads serialize the numpy augmentation on the GIL,
        data/loader.py docstring); thread pool on a single core, where
        process transfer overhead only subtracts."""
        if loader_processes != -1:
            return max(loader_processes, 0)
        ncpu = os.cpu_count() or 1
        return 0 if ncpu <= 2 else min(loader_threads, ncpu - 1)

    def _loader_out_dtype(self):
        """Half-width batch uploads: when the step computes in bf16 and
        the graph opens with a conv (every yolo family — conv entry casts
        its input to compute_dtype, so a host-side pre-cast is
        bit-identical; ops/conv.conv2d_raw), have the loader
        emit bf16 batches.  Halves the per-iteration host->device ship
        (35 MB -> 17.7 MB at 608 b8), cast cost overlapped in the
        assembler thread.  Graphs opening with [crop] (v1) do pre-conv
        input math, so they keep f32."""
        if self.compute_dtype == jnp.bfloat16 and \
                self.graph.layers[0].kind == "convolutional":
            import ml_dtypes

            return ml_dtypes.bfloat16
        return None

    @property
    def curr_iter(self) -> int:
        return self.seen // max(self.net.optimizer_batch, 1)

    # ------------------------------------------------------------------
    def _step_for(self, w: int, h: int):
        """Per-resolution jitted step (multi-scale re-jit, cached)."""
        key = (w, h)
        if key not in self._step_cache:
            if (w, h) == (self.net.w, self.net.h):
                g = self.graph
            else:
                g = self._graph_cache.get(key)
                if g is None:
                    # rebuild the graph at the new input size (the compiler
                    # equivalent of ResizeNetwork, network.cpp:255-410)
                    from darknet_tpu.config.cfg import patch_cfg_dims

                    g = build_graph(patch_cfg_dims(self.cfg, w, h),
                                    train=True)
                    g.net.max_iter = self.net.max_iter
                    self._graph_cache[key] = g
            # subdivisions: micro-batch gradient accumulation exactly like
            # the reference's TrainNetwork subdiv loop (network.cpp:210-230)
            # — also what bounds 608² training memory on one chip
            accum = max(g.net.subdiv, 1)
            # donate params+opt buffers: the trainer reassigns both from
            # the step's outputs, so the old buffers are dead — without
            # donation params/opt/grads triple-reside
            if self.mesh is not None:
                from darknet_tpu.parallel import make_dp_train_step

                step = make_dp_train_step(g, self.mesh,
                                          compute_dtype=self.compute_dtype,
                                          donate=True, accum=accum,
                                          remat=self.remat,
                                          train_act_dtype=self._act_dtype())
            else:
                step = make_train_step(g, compute_dtype=self.compute_dtype,
                                       donate=True, accum=accum,
                                       remat=self.remat,
                                       train_act_dtype=self._act_dtype())
            self._step_cache[key] = step
        return self._step_cache[key]

    def _act_dtype(self):
        import jax.numpy as jnp
        return jnp.bfloat16 if self.act16 else None

    def _pick_dims(self, avg_loss) -> tuple:
        net = self.net
        it = self.curr_iter
        if not self.random_coef:
            return net.w, net.h
        coef = 1.4 if abs(self.random_coef - 1.0) <= 1e-6 else \
            self.random_coef
        rng = np.random.default_rng(it)
        scale = rng.uniform(1.0, coef)
        if rng.integers(0, 2):
            scale = 1.0 / scale
        step = net.resize_step
        dim_w = int(round(scale * net.w / step + 1)) * step
        dim_h = int(round(scale * net.h / step + 1)) * step
        max_w = int(round(coef * net.w / step + 1)) * step
        max_h = int(round(coef * net.h / step + 1)) * step
        if avg_loss < 0 or it > net.max_iter - 100:
            dim_w, dim_h = max_w, max_h
        return max(dim_w, step), max(dim_h, step)

    # ------------------------------------------------------------------
    def train(self, max_iters: int | None = None, map_hook=None):
        """Run the training loop.  Returns the final avg loss."""
        net = self.net
        avg_loss = self._avg_loss      # restored across -resume
        avg_time = -1.0
        best_map = self._best_map      # restored: don't clobber _best
        iter_save = self.curr_iter
        iter_map = max(net.burn_in, self.curr_iter)
        map_step = max(100, self.iter_per_epoch)
        end_iter = net.max_iter if max_iters is None else \
            min(net.max_iter, self.curr_iter + max_iters)
        dim_w, dim_h = self._dims if self._dims else (net.w, net.h)
        key = self._key

        # async metrics pipeline (see __init__): entries are
        # (it, lr, dim_w, dim_h, dt, device_metrics); drained
        # `metric_lag` iterations behind dispatch, fully drained before
        # any evaluate/save/preemption boundary.
        from collections import deque

        pending = deque()
        t_prev = None

        def _drain_one():
            nonlocal avg_loss, avg_time
            p_it, p_lr, p_w, p_h, p_dt, m = pending.popleft()
            loss = float(m["loss"])
            avg_loss = loss if avg_loss < 0 else avg_loss * 0.9 + loss * 0.1
            self._avg_loss = avg_loss
            # hours-left estimate, EMA alpha=0.01 like the reference
            # (detector.cpp:130,255-266)
            remaining = (net.max_iter - p_it) * p_dt / 3600.0
            avg_time = remaining if avg_time < 0 else \
                0.01 * remaining + 0.99 * avg_time
            self.log(f"[{p_it:04d}] loss: {loss:.2f}, avg loss: "
                     f"{avg_loss:.2f}, lr: {p_lr:.2e}, images: "
                     f"{p_it * net.optimizer_batch}, {avg_time:.2f} hours "
                     f"left ({p_dt:.2f}s/iter)")
            self.metrics.step(
                p_it, loss=loss, avg_loss=avg_loss, lr=p_lr,
                imgs_per_sec=net.optimizer_batch / max(p_dt, 1e-9),
                count=int(m["count"]),
                class_loss=float(m["class_loss"]),
                dims=[p_w, p_h])
            self._chart["iters"].append(p_it)
            self._chart["losses"].append(avg_loss)
            if p_it % 10 == 0 or p_it >= end_iter:
                self._render_chart()

        def _drain_all():
            while pending:
                _drain_one()

        # graceful preemption: SIGTERM/SIGINT finish the current
        # iteration, save the full resumable state, then return — on
        # preemptible machines this turns an eviction into an exact
        # resume point (the reference crashes and loses momentum state).
        # Only installable from the main thread; otherwise skipped.
        import signal

        stop_requested = []
        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(
                    sig, lambda *_: stop_requested.append(True))
        except ValueError:
            prev_handlers = {}

        def _stop_agreed() -> bool:
            # multi-host: the signal may reach processes at different
            # iterations (or miss some entirely); exiting unilaterally
            # would strand the others inside the step's cross-process
            # collectives and the checkpoint rendezvous would deadlock.
            # Agree on the flag every iteration — anyone signalled =>
            # everyone stops at the SAME iteration boundary.
            if jax.process_count() <= 1:
                return bool(stop_requested)
            from jax.experimental import multihost_utils

            flags = multihost_utils.process_allgather(
                np.asarray([bool(stop_requested)]))
            agreed = bool(np.any(flags))
            if agreed and not stop_requested:
                stop_requested.append(True)   # so the save branch runs
            return agreed

        while not _stop_agreed() and self.curr_iter < end_iter:
            # multi-scale cadence keyed to the GLOBAL iteration (the
            # reference counts per-process, detector.cpp:141 — the
            # absolute key + per-iteration pick rng makes a resumed run
            # hit the same boundaries the uninterrupted run did; between
            # boundaries the restored `_dims` bucket carries over)
            if self.random_coef and self.curr_iter % 10 == 0:
                # avg_loss may lag by metric_lag iterations here; its only
                # use in _pick_dims is the `< 0` first-iterations guard
                dim_w, dim_h = self._pick_dims(avg_loss)
                self._dims = (dim_w, dim_h)
                self.loader.resize(dim_w, dim_h)
                self.log(f"Resizing: {dim_w} x {dim_h}")
            t0 = time.perf_counter()
            x, y = self.loader.next()
            if x.shape[1:3] != (dim_h, dim_w):
                # stale pre-resize batch in the double buffer; still valid,
                # just belongs to the previous bucket
                dim_h_b, dim_w_b = x.shape[1], x.shape[2]
            else:
                dim_h_b, dim_w_b = dim_h, dim_w

            step = self._step_for(dim_w_b, dim_h_b)
            # LR is indexed by the POST-increment iteration: the reference
            # bumps curr_iter before UpdateNetwork (network.cpp:227-232),
            # so its first update sees iter=1 — with burn_in the 0-based
            # index would make the first update lr=0 and shift the whole
            # ramp by one (caught by the fixed-batch weight-trajectory
            # gate, tests/test_reference_trainloop.py)
            lr = get_lr(net, self.curr_iter + 1,
                        rand01=float(np.random.default_rng(
                            self.curr_iter + 1).uniform()))
            key, sub = jax.random.split(key)
            self._key = key
            args = (self.params, self.opt_state, jnp.asarray(x),
                    jnp.asarray(y), sub, jnp.float32(lr))
            if self.mesh is not None:
                from darknet_tpu.parallel import replicate, shard_batch

                args = (self.params, self.opt_state,
                        shard_batch(self.mesh, x), shard_batch(self.mesh, y),
                        replicate(self.mesh, sub),
                        replicate(self.mesh, jnp.float32(lr)))
            self.params, self.opt_state, cost, metrics = step(*args)

            self.seen += net.optimizer_batch
            it = self.curr_iter
            now = time.perf_counter()
            # per-iter wall: interval between consecutive dispatches once
            # the pipe is full (== blocking per-iter time at lag 0, minus
            # the fetch itself); first iteration falls back to loop time
            dt = now - (t_prev if t_prev is not None else t0)
            t_prev = now
            pending.append((it, lr, dim_w_b, dim_h_b, dt, metrics))
            while len(pending) > self.metric_lag:
                _drain_one()

            if self.calc_map and self.val_paths and \
                    (it >= iter_map or it == net.max_iter):
                _drain_all()
                m = self.evaluate_map()
                self.log(f"mAP@0.5 = {m * 100:.2f}%")
                self.metrics.map_event(it, m)
                self._chart["map_iters"].append(it)
                self._chart["maps"].append(m)
                self._render_chart()
                if m > best_map:
                    best_map = m
                    self._best_map = m
                    self.save(suffix="best")
                iter_map = it + map_step
                if map_hook:
                    map_hook(it, m)

            if it >= iter_save + 1000 or it % 1000 == 0:
                iter_save = it
                _drain_all()       # _avg_loss must be current in the state
                self.save(suffix=str(it))
                if self.full_state:
                    self.save_state()

        _drain_all()
        for sig, h in prev_handlers.items():
            import signal as _signal

            _signal.signal(sig, h)
        if stop_requested:
            self.log(f"Preempted at iteration {self.curr_iter}: "
                     f"saving resumable state")
            self.save(suffix="preempt")
            if self.full_state:
                self.save_state()
            return avg_loss
        self.save(suffix="final")
        if self.full_state:
            self.save_state()
        return avg_loss

    # ------------------------------------------------------------------
    def evaluate_map(self, iou_thresh: float = 0.5) -> float:
        """In-training mAP on a weight-copied inference net
        (net_map/CopyNetWeights, detector.cpp:218-253).  The inference
        Network (and its jitted executables) is cached across calls —
        only the weights are re-copied + re-fused each time, so mAP at
        map_step cadence costs no recompiles after the first."""
        from darknet_tpu.eval.map import validate_detector
        from darknet_tpu.nn.network import Network

        net = getattr(self, "_map_net", None)
        params = [
            {k: np.asarray(v) for k, v in p.items()} for p in self.params]
        if net is None:
            g_inf = build_graph(self.cfg, train=False)
            net = Network(g_inf, paramlib.fuse_conv_batchnorm(g_inf, params),
                          fused=True)
            self._map_net = net
        else:
            net.params = paramlib.fuse_conv_batchnorm(net.graph, params)
        # the reference's in-training mAP loads with its own bilinear
        # (detector.cpp:218-253 -> load_image + resize_image)
        batch = 4 if len(self.val_paths) >= 4 else 1
        mesh = None
        if self.mesh is not None and "dp" in self.mesh.axis_names:
            # ride the training mesh: batch-sharded forward, host PR math
            from darknet_tpu.parallel.mesh import round_batch_to_mesh

            n_dp = self.mesh.shape["dp"]
            if len(self.val_paths) >= n_dp:
                mesh = self.mesh
                batch = round_batch_to_mesh(batch, n_dp)
        res = validate_detector(net, self.val_paths, self.classes,
                                iou_thresh=iou_thresh, progress=False,
                                batch=batch, resize="darknet", mesh=mesh)
        return res.map

    def _render_chart(self) -> None:
        """chart.png + live window (the reference draws per iteration with
        max_loss=5, detector.cpp:122-123,269-270; we render every 10th —
        a PNG encode per iteration would be ~10% of a fast step)."""
        from darknet_tpu.apps import visualize as viz

        if viz.cv2 is None:
            return                       # cv2-less environment: skip
        os.makedirs(self.save_dir, exist_ok=True)
        img = viz.draw_loss_chart(
            self._chart["iters"], self._chart["losses"],
            self._chart["map_iters"], self._chart["maps"],
            max_iter=self.net.max_iter,
            path=os.path.join(self.save_dir, "chart.png"))
        viz.safe_imshow("average loss", img[..., ::-1])

    def save_state(self, path: str | None = None) -> str:
        """Write the rolling full-state checkpoint (params + optimizer
        slots + seen + rng key) so training can resume exactly — the
        reference restarts from `.weights` alone and loses momentum
        (SURVEY.md §5 gap).  Single-process: one `.ckpt.npz` file.
        Multi-process (jax.process_count() > 1): falls back to the
        orbax-backed sharded directory format, each process writing
        only its own shards."""
        from darknet_tpu.train import checkpoint as ck

        os.makedirs(self.save_dir, exist_ok=True)
        path = path or self.state_path
        extra = {"avg_loss": self._avg_loss, "best_map": self._best_map}
        if self._dims:
            extra["dim_w"], extra["dim_h"] = self._dims
        if self._chart["iters"]:
            extra["chart_iters"] = np.asarray(self._chart["iters"], np.int64)
            extra["chart_losses"] = np.asarray(self._chart["losses"],
                                               np.float32)
        if self._chart["map_iters"]:
            # separate guard: orbax's sharded writer refuses zero-size
            # arrays, and runs without mAP events have an empty history
            extra["chart_map_iters"] = np.asarray(self._chart["map_iters"],
                                                  np.int64)
            extra["chart_maps"] = np.asarray(self._chart["maps"], np.float32)
        if jax.process_count() > 1:
            path = path[:-len(".npz")] if path.endswith(".npz") else path
            ck.save_checkpoint_sharded(path, self.params, self.opt_state,
                                       seen=self.seen,
                                       rng_key=np.asarray(self._key),
                                       extra=extra)
        else:
            ck.save_checkpoint(path, jax.device_get(self.params),
                               jax.device_get(self.opt_state),
                               seen=self.seen, rng_key=np.asarray(self._key),
                               extra=extra)
        self.log(f"Saving full train state to {path}")
        return path

    def load_state(self, path: str | None = None) -> None:
        """Restore params/opt/seen/rng from a full-state checkpoint
        written by save_state (exact resume)."""
        from darknet_tpu.train import checkpoint as ck

        path = path or self.state_path
        if os.path.isdir(path) or ck.resolve_sharded_dir(path):
            # a base dir name whose state sits at a .tmp/.old swap
            # sibling resolves (and is promoted) inside the loader
            loader = ck.load_checkpoint_sharded
        else:
            loader = ck.load_checkpoint
        params, opt, seen, rng, extra = loader(path, self.params,
                                               self.opt_state)
        self.params, self.opt_state, self.seen = params, opt, seen
        if rng is not None:
            self._key = jnp.asarray(rng)
        self._avg_loss = float(extra.get("avg_loss", -1.0))
        self._best_map = float(extra.get("best_map", 0.0))
        if "chart_iters" in extra:
            self._chart = {
                "iters": [int(v) for v in extra["chart_iters"]],
                "losses": [float(v) for v in extra["chart_losses"]],
                "map_iters": [int(v) for v in
                              extra.get("chart_map_iters", [])],
                "maps": [float(v) for v in extra.get("chart_maps", [])],
            }
        if "dim_w" in extra:
            # restore the multi-scale bucket the saved run was training
            # at, so the resumed batches match the uninterrupted stream
            self._dims = (int(extra["dim_w"]), int(extra["dim_h"]))
            if getattr(self, "loader", None) is not None:
                self.loader.resize(*self._dims)
        if getattr(self, "loader", None) is not None:
            # continue the loader's seed stream where the saved run left
            # it, so the resumed run sees the same batches the
            # uninterrupted run would have
            self.loader.fast_forward(self.curr_iter)
        self.log(f"Resumed full train state from {path} "
                 f"(iteration {self.curr_iter})")

    def close(self) -> None:
        """Stop the loader pool (idempotent)."""
        if getattr(self, "loader", None) is not None:
            self.loader.close()

    def save(self, suffix: str = "") -> str:
        name = f"{self.save_name}_{suffix}.weights" if suffix \
            else f"{self.save_name}.weights"
        path = os.path.join(self.save_dir, name)
        if jax.process_index() != 0:
            # one writer: under multi-host DP the params are replicated,
            # and two processes appending to the same file concurrently
            # would interleave; the sharded full-state save (save_state)
            # is the collective one
            return path
        os.makedirs(self.save_dir, exist_ok=True)
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in self.params]
        wio.save_weights(self.graph, params, path, seen=self.seen)
        self.log(f"Saving weights to {path}")
        return path


def train_detector(data_file: str, model_file: str,
                   weights_file: str | None = None, *, clear: bool = False,
                   max_iters: int | None = None, calc_map: bool = False,
                   loader_processes: int = 0, **kw) -> float:
    """TrainDetector with the reference's own entry signature
    (yolo_core.h:640-642: Metadata + model_file + weights_file;
    detector.cpp:27-324): resolve the .data file, build the trainer, run
    the loop, return the final EMA avg loss (-1.0 when zero iterations
    ran).  This is the function the C ABI's dtpu_train binds —
    loader_processes therefore defaults to 0 (thread pool): the spawn
    process pool execs sys.executable, which inside an embedding C
    application is not guaranteed to be a provisioned Python
    interpreter."""
    from darknet_tpu.config.metadata import Metadata

    md = Metadata.from_file(data_file)
    train_paths = md.load_paths("train")
    val_paths = (md.load_paths("valid")
                 if (calc_map and md.valid_list) else [])
    weights = (weights_file
               if weights_file and os.path.exists(weights_file) else None)
    trainer = DetectorTrainer(
        model_file, train_paths, weights=weights, classes=md.classes,
        clear=clear, calc_map=calc_map and bool(val_paths),
        val_paths=val_paths, save_dir=md.backup_dir,
        save_name=os.path.splitext(os.path.basename(model_file))[0]
        or "model", loader_processes=loader_processes, **kw)
    try:
        return float(trainer.train(max_iters=max_iters))
    finally:
        trainer.close()
