"""Per-layer cost report — the `-benchmark_layers` equivalent
(network_kernels.cu:27-114: per-layer wall time with device sync, EMA 0.9,
sorted report).

`trace_report` runs the program under `jax.profiler.trace`, joins the
device op durations against the compiled HLO's `op_name` metadata (which
carries the emitter's per-layer `jax.named_scope` tags, nn/emit.py), and
prints the reference's sorted per-layer table.  It measures the real fused
program on the device.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import re

import jax


def _hlo_op_scopes(compiled_text: str) -> dict:
    """Map each HLO op id -> the emitter's layer scope from its op_name
    metadata (e.g. op_name="jit(f)/L042_convolutional/conv_general...")."""
    scopes = {}
    for m in re.finditer(
            r"%?([\w.\-]+) = .*?metadata=\{[^}]*?op_name=\"([^\"]+)\"",
            compiled_text):
        op, op_name = m.group(1), m.group(2)
        s = re.search(r"(L\d{3}(?:-\d{3})?_[\w]+)", op_name)
        if s is None:
            # non-layer scopes from the train step: optimizer_update /
            # head_delta_N (train/step.py) — keeps "(other)" honest
            s = re.search(r"((?:optimizer_update|head_delta_\d+))", op_name)
        scopes[op] = s.group(1) if s else None
    return scopes


def device_op_durations(events) -> dict:
    """Sum each HLO op's duration (microseconds) over a Chrome-format trace.

    Op events carry `args.hlo_op`.  On the GPU they sit on the
    `/device:GPU:N` processes (one per card, a thread per stream; the host
    has launch events without `hlo_op`); on the CPU backend they run on
    host threads.  When any `/device:` process exists, only its events
    count."""
    dev_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and str((e.get("args") or {}).get("name", "")).startswith(
                    "/device:")}
    per_op: dict = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if dev_pids and e.get("pid") not in dev_pids:
            continue
        op = (e.get("args") or {}).get("hlo_op")
        if op:
            per_op[op] += e["dur"]
    return per_op


def trace_report(fn, *args, graph=None, iters: int = 5, log=print,
                 trace_dir: str | None = None, top: int = 0):
    """Profile `fn(*args)` on its device and print a sorted per-layer cost
    table (the -benchmark_layers contract, network_kernels.cu:92-113).

    fn is jitted if it isn't already; the first call compiles.  Each HLO
    op's device duration is attributed to the cfg layer whose
    `jax.named_scope` tag (nn/emit.py) appears in its op_name metadata;
    unattributed time is reported as "(other)".  When `graph` is given the
    table also shows each layer's static BFLOPs (parser.cpp:1461).

    Returns a list of (scope, ms_per_iter, bflops) sorted descending.
    """
    import shutil
    import tempfile

    jfn = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(fn)
    compiled = jfn.lower(*args).compile()
    scopes = _hlo_op_scopes(compiled.as_text())

    # run the AOT-compiled executable directly — calling jfn would compile
    # a second time through the jit dispatch cache
    jax.block_until_ready(compiled(*args))          # warm
    tdir = trace_dir or tempfile.mkdtemp(prefix="dk_trace_")
    with jax.profiler.trace(tdir):
        for _ in range(iters):
            r = compiled(*args)
        jax.block_until_ready(r)

    files = sorted(glob.glob(f"{tdir}/**/*.trace.json.gz", recursive=True))
    if not files:
        raise RuntimeError(f"no trace produced under {tdir}")
    events = json.load(gzip.open(files[-1]))["traceEvents"]
    if trace_dir is None:
        shutil.rmtree(tdir, ignore_errors=True)   # traces can be 100s of MB
    per_op = device_op_durations(events)
    if not per_op:
        raise RuntimeError(
            "trace_report: the trace attributes no device time to any HLO "
            "op (unknown trace schema, or nothing ran)")

    per_scope: dict = collections.Counter()
    for op, dur in per_op.items():
        per_scope[scopes.get(op) or "(other)"] += dur

    bflops = {}
    if graph is not None:
        for l in graph.layers:
            for key in per_scope:
                if key.startswith(f"L{l.index:03d}_"):
                    bflops[key] = l.bflops
                elif "-" in key and key.startswith("L"):
                    m = re.match(r"L(\d{3})-(\d{3})_", key)
                    if m and m.group(1) <= f"{l.index:03d}" <= m.group(2):
                        bflops[key] = bflops.get(key, 0.0) + l.bflops

    rows = sorted(((k, v / iters / 1000.0, bflops.get(k, 0.0))
                   for k, v in per_scope.items()),
                  key=lambda r: -r[1])
    total_ms = sum(r[1] for r in rows)
    log(f"{'layer':<28} {'ms/iter':>9} {'%':>6} {'BFLOPs':>8} {'TFLOP/s':>8}")
    shown = rows[:top] if top else rows
    for k, ms, bf in shown:
        tf = (bf / ms) if ms > 0 else 0.0   # BFLOP/ms == TFLOP/s
        log(f"{k:<28} {ms:9.3f} {100 * ms / max(total_ms, 1e-9):5.1f}% "
            f"{bf:8.2f} {tf:8.1f}")
    log(f"{'TOTAL (device)':<28} {total_ms:9.3f}")
    return rows
