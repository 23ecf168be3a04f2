"""Per-layer cost report (utils/profiler.trace_report) — the productized
`-benchmark_layers` contract (network_kernels.cu:46-114): a real profiler
trace, joined to HLO op_name metadata, attributed back to cfg layers."""

import numpy as np
import pytest

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.nn.emit import make_forward
from darknet_tpu.utils.profiler import trace_report

CFG = """[net]
batch=1
subdivisions=1
width=64
height=64
channels=3
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[maxpool]
size=2
stride=2
[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=mish
[convolutional]
filters=12
size=1
activation=linear
[yolo]
mask=0,1
num=2
classes=1
anchors=10,14, 23,27
"""


def test_trace_report_attributes_layers(tmp_path):
    g = build_graph(CFG)
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=0))
    fwd = make_forward(g, fused_bn=True)
    x = jnp.asarray(np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))

    lines = []
    rows = trace_report(lambda p, x: fwd(p, x)["output"], params, x,
                        graph=g, iters=2, log=lines.append,
                        trace_dir=str(tmp_path / "trc"))

    scopes = {r[0] for r in rows}
    # conv layers must be individually attributed via their named scopes
    assert any(s.startswith("L000_convolutional") for s in scopes), scopes
    assert any(s.startswith("L002_convolutional") for s in scopes), scopes
    total = sum(r[1] for r in rows)
    assert total > 0
    # rows are sorted descending by time
    times = [r[1] for r in rows]
    assert times == sorted(times, reverse=True)
    # BFLOPs joined from the IR for the attributed conv rows
    conv_rows = [r for r in rows if r[0].startswith("L002_")]
    if conv_rows:
        assert conv_rows[0][2] == pytest.approx(
            g.layers[2].bflops, rel=1e-6)
    # the printed table ends with the device total
    assert any("TOTAL" in ln for ln in lines)


def _gpu_events():
    """A GPU trace as jax.profiler writes it: kernels on the device
    process carry args.hlo_op; host launch events do not count."""
    return [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 13, "name": "thread_name",
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "pid": 701, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 13, "dur": 12.5, "name": "sm90_xmma",
         "args": {"hlo_op": "cudnn-conv.3", "hlo_module": "jit_f"}},
        {"ph": "X", "pid": 1, "tid": 13, "dur": 2.5, "name": "sm90_xmma",
         "args": {"hlo_op": "cudnn-conv.3", "hlo_module": "jit_f"}},
        {"ph": "X", "pid": 1, "tid": 13, "dur": 1.0, "name": "loop_fusion",
         "args": {"hlo_op": "loop_fusion", "hlo_module": "jit_f"}},
        {"ph": "X", "pid": 701, "tid": 5, "dur": 99.0, "name": "launch",
         "args": {"hlo_op": "cudnn-conv.3"}},
    ]


def test_device_op_durations_reads_gpu_schema():
    from darknet_tpu.utils.profiler import device_op_durations

    assert device_op_durations(_gpu_events()) == {"cudnn-conv.3": 15.0,
                                                  "loop_fusion": 1.0}
    # CPU backend: no /device: process, ops run on host threads
    cpu = [e for e in _gpu_events() if e.get("pid") == 701]
    assert device_op_durations(cpu) == {"cudnn-conv.3": 99.0}


def test_trace_report_fails_without_device_time(tmp_path, monkeypatch):
    """A trace that attributes no time to any op is an error, not an
    empty table."""
    from darknet_tpu.utils import profiler

    monkeypatch.setattr(profiler, "device_op_durations", lambda ev: {})
    with pytest.raises(RuntimeError, match="no device time"):
        profiler.trace_report(lambda x: x * 2, jnp.ones(4), iters=1,
                              log=lambda *a: None,
                              trace_dir=str(tmp_path / "t"))
