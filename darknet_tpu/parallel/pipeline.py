"""Pipeline parallelism — stage-partitioned inference across devices.

The reference has no model-parallel mode (SURVEY.md §2.7); this is the
layer-axis split completing the dp/sp/tp set: the layer graph
is cut into contiguous stages balanced by BFLOPs, each stage's params
live only on its device, and micro-batches stream through the stages.
JAX's async dispatch is the pipeline schedule — stage s of micro-batch m
runs concurrently with stage s-1 of micro-batch m+1 because each jitted
stage call only depends on its own inputs; device-to-device transfers
ride NVLink between cards.

Cross-stage dataflow is computed from the graph: a cut at layer c must
carry layer c-1's output (the sequential `cur`) plus every earlier
output still consumed at or after c (route/shortcut/scale_channels
back-references — yolov4's neck reaches ~60 layers back into the
backbone).  The stage executor is the stock emitter in slice mode
(nn/emit.make_forward's _lo/_hi/_extern), so every layer-kind quirk is
inherited rather than reimplemented.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def consumed(layer, i: int) -> list:
    """Graph indices layer i reads: routes consume exactly their listed
    layers; everything else implicitly consumes i-1 plus any extra edges
    (shortcut/scale_channels from_layer)."""
    if layer.kind == "route":
        return list(layer.input_indices())
    return ([i - 1] if i > 0 else []) + list(layer.input_indices())


def crossing_set(graph, cut: int) -> list:
    """Sorted indices j < cut-1 whose outputs are consumed at/after cut.
    (cut-1 itself travels as the sequential activation, not in the set —
    unless a layer >= cut back-references it explicitly, which still
    resolves because the stage seeds outs with cut-1 when listed.)"""
    need = set()
    for i in range(cut, len(graph.layers)):
        for s in consumed(graph.layers[i], i):
            if 0 <= s < cut:
                need.add(s)
    need.discard(cut - 1)
    return sorted(need)


def plan_cuts(graph, n_stages: int, *, forbidden=()) -> list:
    """Stage boundaries [c_1..c_{S-1}] balancing cumulative BFLOPs,
    snapped away from `forbidden` positions (share_index spans)."""
    bf = np.array([l.bflops or 0.0 for l in graph.layers])
    cum = np.cumsum(bf)
    total = cum[-1] if len(cum) else 0.0
    forbidden = set(forbidden)
    n = len(graph.layers)
    cuts = []
    for s in range(1, n_stages):
        target = total * s / n_stages
        c = int(np.searchsorted(cum, target)) + 1
        # every candidate must be > the previous cut (non-empty stages,
        # monotone order) AND outside `forbidden` — snap forward first,
        # then backward, never violating either constraint
        lo = cuts[-1] + 1 if cuts else 1
        c = max(lo, min(c, n - 1))
        fwd = c
        while fwd in forbidden and fwd < n - 1:
            fwd += 1
        if fwd not in forbidden:
            c = fwd
        else:
            bwd = c
            while bwd in forbidden and bwd > lo:
                bwd -= 1
            if bwd in forbidden:
                raise ValueError(
                    f"pipeline stage {s}: no legal cut in [{lo}, {n - 1}] — "
                    f"every position is inside a share_index span; "
                    f"reduce n_stages")
            c = bwd
        cuts.append(c)
    return cuts


def _forbidden_cuts(graph) -> set:
    out = set()
    # weight-shared convs (share_index, parser.cpp:211-216) must live in
    # the same stage as their source: a cut between them would leave the
    # borrower reading a param copy the owner's optimizer never updates
    for i, l in enumerate(graph.layers):
        s = getattr(l, "share_index", None)
        if l.kind == "convolutional" and s is not None:
            out.update(range(s + 1, i + 1))
    return out


class PipelineForward:
    """Stage-partitioned inference executor.

    fn = PipelineForward(graph, params, devices); heads = fn(x)
    Each stage's param slice is resident only on its device; `x` is split
    into `microbatches` chunks that stream through the stages.
    """

    def __init__(self, graph, params, devices, *, compute_dtype=None,
                 fused_bn: bool = True, microbatches: int = 2):
        from darknet_tpu.nn.emit import make_forward

        fwd = make_forward(graph, compute_dtype=compute_dtype,
                           fused_bn=fused_bn)
        n_stages = len(devices)
        forb = _forbidden_cuts(graph)
        cuts = plan_cuts(graph, n_stages, forbidden=forb)
        bounds = [0] + cuts + [len(graph.layers)]
        self.devices = list(devices)
        self.microbatches = microbatches
        self.stages = []
        for s in range(n_stages):
            lo, hi = bounds[s], bounds[s + 1]
            keys_in = crossing_set(graph, lo) if lo else []
            keys_out = crossing_set(graph, hi) if hi < len(graph.layers) \
                else []
            needed = set(range(lo, hi))
            for l in graph.layers[lo:hi]:
                if (l.kind == "convolutional"
                        and getattr(l, "share_index", None) is not None):
                    needed.add(l.share_index)
            params_s = [p if i in needed else {}
                        for i, p in enumerate(params)]
            params_s = jax.device_put(params_s, self.devices[s])

            def stage(params, cur, ext, lo=lo, hi=hi,
                      keys_in=tuple(keys_in), keys_out=tuple(keys_out)):
                extern = dict(zip(keys_in, ext))
                if lo:
                    extern[lo - 1] = cur    # cur IS layer lo-1's output;
                    # keys_out may carry it to a later back-reference
                r = fwd(params, cur, _lo=lo, _hi=hi, _extern=extern)
                return (r["output"], tuple(r["outs"][k] for k in keys_out),
                        tuple(r["heads"]))

            self.stages.append({
                "lo": lo, "hi": hi, "keys_in": tuple(keys_in),
                "keys_out": tuple(keys_out), "params": params_s,
                "fn": jax.jit(stage)})

    def _run_micro(self, x):
        cur, ext = x, ()
        heads = []
        for s, st in enumerate(self.stages):
            dev = self.devices[s]
            cur = jax.device_put(cur, dev)
            ext = tuple(jax.device_put(e, dev) for e in ext)
            cur, ext_out, heads_s = st["fn"](st["params"], cur, ext)
            # re-key: next stage's keys_in ⊆ this stage's keys_out ∪ keys_in
            produced = dict(zip(st["keys_out"], ext_out))
            carry_in = dict(zip(st["keys_in"], ext))
            nxt = self.stages[s + 1]["keys_in"] \
                if s + 1 < len(self.stages) else ()
            ext = tuple(produced.get(k, carry_in.get(k)) for k in nxt)
            heads.extend(heads_s)
        return heads

    def __call__(self, x):
        x = jnp.asarray(x)
        m = max(1, min(self.microbatches, x.shape[0]))
        chunks = np.array_split(np.arange(x.shape[0]), m)
        outs = [self._run_micro(x[c[0]:c[-1] + 1]) for c in chunks if len(c)]
        heads = [jnp.concatenate([o[h] for o in outs], axis=0)
                 for h in range(len(outs[0]))]
        return heads


class PipelineTrain:
    """GPipe-style pipeline-parallel TRAINING over the stage split.

    Forward phase: micro-batches stream through the stages (stage s of
    micro m overlaps stage s-1 of micro m+1 via async dispatch), storing
    only the stage BOUNDARY activations.  Backward phase: per micro, in
    reverse stage order, each stage re-runs its forward inside jax.vjp
    (full per-stage rematerialization — the GPipe memory profile) and
    computes its own heads' deltas locally (train/step.head_delta), so
    truth tensors and loss math live on the device that owns the head.
    Cotangents for cross-stage tensors (including long route
    back-references carried through intermediate stages as identities)
    flow through each stage's vjp automatically.  Per-stage optimizer:
    each device updates only its own param slice with its own SGD/Adam
    slots — params, grads AND optimizer state all scale with 1/n_stages.

    Gradient semantics match make_train_step(accum=microbatches): micro
    grads are summed, one optimizer apply per step, sequential 0.9/0.1
    BN rolling updates per micro, interleaved micro assignment.
    """

    def __init__(self, graph, params, devices, *, microbatches: int = 2,
                 use_adam: bool | None = None, compute_dtype=None,
                 remat: bool = False, iter0: int = 0):
        from darknet_tpu.nn.emit import make_forward
        from darknet_tpu.train import optimizer as opt
        from darknet_tpu.train.step import head_delta, init_opt_state

        net = graph.net
        self.graph = graph
        self.net = net
        self.use_adam = net.adam if use_adam is None else use_adam
        self.microbatches = microbatches
        self.devices = list(devices)
        fwd = make_forward(graph, train=True, compute_dtype=compute_dtype,
                           remat=remat)
        n_stages = len(self.devices)
        forb = _forbidden_cuts(graph)
        cuts = plan_cuts(graph, n_stages, forbidden=forb)
        bounds = [0] + cuts + [len(graph.layers)]
        head_layers = [(i, l) for i, l in enumerate(graph.layers)
                       if l.kind in ("yolo", "gaussian_yolo", "detection",
                                     "cost")]
        self.n_heads = len(head_layers)
        loss_scale = net.loss_scale
        self.stages = []
        for s in range(n_stages):
            lo, hi = bounds[s], bounds[s + 1]
            keys_in = tuple(crossing_set(graph, lo) if lo else ())
            keys_out = tuple(crossing_set(graph, hi)
                             if hi < len(graph.layers) else ())
            sheads = [(gh, l) for gh, (li, l) in enumerate(head_layers)
                      if lo <= li < hi]
            params_s = [p if lo <= i < hi else {}
                        for i, p in enumerate(params)]
            params_s = jax.device_put(params_s, self.devices[s])
            opt_s = jax.device_put(
                init_opt_state(graph, params_s, self.use_adam, iter0=iter0),
                self.devices[s])

            def run_slice(params, cur, ext, rng, lo=lo, hi=hi,
                          keys_in=keys_in, keys_out=keys_out):
                extern = dict(zip(keys_in, ext))
                if lo:
                    extern[lo - 1] = cur
                r = fwd(params, cur, rng, _lo=lo, _hi=hi, _extern=extern)
                outs = tuple(r["outs"][k] for k in keys_out)
                return ((r["output"], outs, tuple(r["raw_heads"])),
                        r["bn_stats"])

            def stage_fwd(params, cur, ext, rng, run_slice=run_slice):
                (out, outs, _), _ = run_slice(params, cur, ext, rng)
                return out, outs

            def stage_bwd(params, cur, ext, rng, truths, g_out, g_ext,
                          run_slice=run_slice, sheads=tuple(sheads),
                          last=False):
                (out, ext_out, raws), vjp_fn, bn_stats = jax.vjp(
                    lambda p, c, e: run_slice(p, c, e, rng),
                    params, cur, ext, has_aux=True)
                deltas, costs, mets = [], [], []
                for raw, (gh, l) in zip(raws, sheads):
                    d, c, m = head_delta(raw, truths, l, net, rng, gh)
                    deltas.append(d.astype(raw.dtype) * loss_scale)
                    costs.append(c)
                    mets.append(m)
                if last:
                    g_out = jnp.zeros_like(out)
                g_params, g_cur, g_ext_in = vjp_fn(
                    (g_out, g_ext, tuple(deltas)))
                if loss_scale != 1.0:
                    g_params = jax.tree_util.tree_map(
                        lambda g: g / loss_scale, g_params)
                cost = (jnp.sum(jnp.stack(costs)) if costs
                        else jnp.float32(0))
                return g_params, g_cur, g_ext_in, cost, mets, bn_stats

            def stage_update(params, opt_state, grads, lr, bn_mc, bn_vc,
                             keep):
                if self.use_adam:
                    params, opt_state = opt.adam_update(
                        graph, params, grads, opt_state, lr=lr, B1=net.B1,
                        B2=net.B2, eps=net.eps, decay=net.decay,
                        batch=net.optimizer_batch)
                else:
                    params, opt_state = opt.sgd_update(
                        graph, params, grads, opt_state, lr=lr,
                        momentum=net.momentum, decay=net.decay,
                        batch=net.optimizer_batch)
                new_params = []
                for i, p in enumerate(params):
                    if i in bn_mc and "mean" in p:
                        p = dict(p)
                        p["mean"] = keep * p["mean"] + bn_mc[i]
                        p["var"] = keep * p["var"] + bn_vc[i]
                    new_params.append(p)
                return new_params, opt_state

            self.stages.append({
                "lo": lo, "hi": hi, "keys_in": keys_in, "keys_out": keys_out,
                "has_heads": bool(sheads), "params": params_s, "opt": opt_s,
                "fwd": jax.jit(stage_fwd),
                "bwd": jax.jit(stage_bwd, static_argnames=("last",)),
                "update": jax.jit(stage_update,
                                  static_argnames=("keep",),
                                  donate_argnums=(0, 1))})

    def step(self, x, truths, rng, lr):
        """One optimizer step over the full batch; returns (cost, metrics).
        Params/opt state stay resident per stage (self.stages[s])."""
        S = len(self.stages)
        M = self.microbatches
        b = x.shape[0]
        assert b % M == 0, (b, M)
        # interleaved micro assignment, same as make_train_step(accum=M);
        # the split stays on host — each micro is device_put to its own
        # stage device below, so a whole-batch device copy here would be
        # a wasted round-trip
        xm = np.moveaxis(np.asarray(x).reshape(b // M, M, *x.shape[1:]),
                         1, 0)
        tm = np.moveaxis(
            np.asarray(truths).reshape(b // M, M, *truths.shape[1:]), 1, 0)
        # M == 1 keeps the caller's key unsplit, matching
        # make_train_step(accum=1) (which only splits when accum > 1)
        rngs = ([rng] * M if rng is None or M == 1
                else list(jax.random.split(rng, M)))

        # ---- forward phase: stream boundary activations ----
        stage_in = [[None] * S for _ in range(M)]
        for m in range(M):
            cur = jax.device_put(jnp.asarray(xm[m]), self.devices[0])
            ext = ()
            for s in range(S):
                stage_in[m][s] = (cur, ext)
                if s == S - 1:
                    break
                out, ext_out = self.stages[s]["fwd"](
                    self.stages[s]["params"], cur, ext, rngs[m])
                dev = self.devices[s + 1]
                cur = jax.device_put(out, dev)
                ext = tuple(jax.device_put(e, dev) for e in ext_out)

        # ---- backward phase: reverse stages per micro ----
        grads = [None] * S
        bn_per_stage = [[] for _ in range(S)]
        costs, mets_by_head = [], {}
        for m in range(M):
            g_cur, g_ext = None, None
            for s in range(S - 1, -1, -1):
                st = self.stages[s]
                dev = self.devices[s]
                cur, ext = stage_in[m][s]
                t_dev = jax.device_put(
                    jnp.asarray(tm[m]) if st["has_heads"]
                    else jnp.zeros((1, 1, 5), jnp.float32), dev)
                last = s == S - 1
                if last:
                    g_out = cur    # ignored under last=True (shape donor)
                    g_ext = ()
                else:
                    g_out = jax.device_put(g_cur, dev)
                    g_ext = tuple(jax.device_put(g, dev) for g in g_ext)
                g_params, g_cur, g_ext, cost, mets, bn = st["bwd"](
                    st["params"], cur, ext, rngs[m], t_dev, g_out, g_ext,
                    last=last)
                grads[s] = g_params if grads[s] is None else \
                    jax.tree_util.tree_map(jnp.add, grads[s], g_params)
                bn_per_stage[s].append(bn)
                # scalars aggregate on stage 0's device
                costs.append(jax.device_put(cost, self.devices[0]))
                if st["has_heads"]:
                    base = sum(1 for i, l in enumerate(self.graph.layers)
                               if i < st["lo"] and l.kind in
                               ("yolo", "gaussian_yolo", "detection",
                                "cost"))
                    for k, mh in enumerate(mets):
                        mh = jax.tree_util.tree_map(
                            lambda a: jax.device_put(a, self.devices[0]),
                            mh)
                        mets_by_head.setdefault(base + k, []).append(mh)

        self._last_grads = grads      # debug/introspection hook
        # ---- update phase: per-stage optimizer + BN rolling ----
        keep = 0.9 ** M
        wgt = [0.1 * (0.9 ** (M - 1 - j)) for j in range(M)]
        for s, st in enumerate(self.stages):
            bn_mc, bn_vc = {}, {}
            for j, bn in enumerate(bn_per_stage[s]):
                for i, (mu, var) in bn.items():
                    bn_mc[i] = bn_mc.get(i, 0) + wgt[j] * mu
                    bn_vc[i] = bn_vc.get(i, 0) + wgt[j] * var
            st["params"], st["opt"] = st["update"](
                st["params"], st["opt"], grads[s], jnp.float32(lr),
                bn_mc, bn_vc, keep)

        cost = sum(costs[1:], costs[0])
        # same aggregation as make_train_step(accum=M) — shared helper
        from darknet_tpu.train.step import aggregate_micro_metrics

        metrics_list = [
            aggregate_micro_metrics(
                {k: jnp.stack([m[k] for m in mets_by_head[h]])
                 for k in mets_by_head[h][0]})
            for h in sorted(mets_by_head)]
        metrics = {
            "loss": sum(m["loss"] for m in metrics_list),
            "avg_iou": sum(m["avg_iou"] for m in metrics_list)
            / max(self.n_heads, 1),
            "count": sum(m["count"] for m in metrics_list),
            "class_loss": sum(m["class_loss"] for m in metrics_list),
            "iou_loss_mag": sum(m["iou_loss"] for m in metrics_list),
        }
        return cost, metrics

    def gather_params(self):
        """Merge the per-stage slices back into one full params list
        (host/default device) — for checkpointing via weights/io."""
        full = [dict(p) for p in self.stages[0]["params"]]
        for st in self.stages[1:]:
            for i, p in enumerate(st["params"]):
                if p:
                    full[i] = dict(p)
        return jax.device_get(full)
