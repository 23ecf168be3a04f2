"""chip_smoke.py and bench.py: they refuse to run without a GPU, and the
smoke test's comparison helpers judge agreement correctly (driven here at a
tiny cfg on the CPU; on the card they compare the card with the CPU)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = """[net]
batch=4
subdivisions=2
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
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=mish
[convolutional]
filters=18
size=1
stride=1
pad=1
activation=linear
[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58
classes=1
num=3
"""


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--four"]),
                                         ("bench.py", [])])
def test_refuses_to_run_without_gpu(script, args):
    proc = subprocess.run([sys.executable, script, *args], cwd=REPO,
                          env=_cpu_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout and "img/s" not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_rel_l2():
    a = np.array([3.0, 4.0])
    assert cs.rel_l2(a, a) == 0.0
    assert cs.rel_l2(a + [0.0, 0.5], a) == pytest.approx(0.1)
    assert cs.rel_l2(np.zeros(2), np.zeros(2)) == 0.0
    assert cs.rel_l2(np.ones(2), np.zeros(2)) == float("inf")


def _tiny_net(compute_dtype=None):
    from darknet_tpu.nn.network import Network

    return Network.from_cfg(TINY, seed=3, compute_dtype=compute_dtype)


def test_compare_heads_accepts_same_and_rejects_perturbed():
    net = _tiny_net()
    x, _ = cs.synth_batch(np.random.default_rng(0), 1, 64, 90)
    heads, _ = net.forward_heads(x)
    ok, rels = cs.compare_heads(heads, heads, 1e-6)
    assert ok and rels == [0.0]
    bad = [h * 1.01 for h in heads]
    ok, rels = cs.compare_heads(bad, heads, 1e-3)
    assert not ok and rels[0] == pytest.approx(0.01, rel=1e-3)
    nan = [np.full_like(heads[0], np.nan)]
    assert not cs.compare_heads(nan, heads, 1.0)[0]
    assert not cs.compare_heads(heads + heads, heads, 1.0)[0]


def test_device_nms_matches_host_at_candidate_thresh():
    net = _tiny_net()
    x, _ = cs.synth_batch(np.random.default_rng(1), 2, 64, 90)
    top_k = 32
    thresh = cs.candidate_thresh(net, x, top_k, floor=0.0)
    _h, dec = net.forward_heads(x)
    assert (np.asarray(dec[1]) > thresh).sum(axis=1).max() <= top_k
    host = net.detect_batch(x, thresh=thresh, nms=0.45)
    dev = net.detect_batch_device(x, thresh=thresh, nms=0.45, top_k=top_k)
    for d, h in zip(dev, host):
        ok, msg = cs.match_detections(d, h)
        assert ok, msg
    if host[0]:
        ok, _ = cs.match_detections(dev[0][1:], host[0])
        assert not ok
        moved = list(dev[0])
        moved[0] = dataclasses.replace(
            moved[0], bbox=tuple(v + 1e-2 for v in moved[0].bbox))
        ok, _ = cs.match_detections(moved, host[0])
        assert not ok


def test_micro_grads_compare_per_layer():
    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib

    g = build_graph(TINY, train=True)
    assert g.net.batch == 2                       # the micro-batch
    params = paramlib.init_params(g, seed=0)
    x, t = cs.synth_batch(np.random.default_rng(2), g.net.batch, 64,
                          g.heads()[-1].max_boxes)
    assert t[:, 0, 2].min() > 0                    # every image has a box
    fn = cs.micro_grads_fn(g)
    g1, c1 = jax.device_get(fn(params, x, t))
    g2, c2 = jax.device_get(fn(params, x, t))
    assert np.isfinite(c1) and c1 == c2
    errs = cs.layer_errors(g2, g1)
    assert errs == {0: 0.0, 1: 0.0, 2: 0.0}
    g2[1] = {k: v * 1.1 for k, v in g2[1].items()}
    errs = cs.layer_errors(g2, g1)
    assert errs[1] == pytest.approx(0.1, rel=1e-4)
    ok, wi, worst = cs.within(errs, 1e-3)
    assert not ok and wi == 1 and worst == errs[1]


def test_conv_dtype_tally_reads_operand_types():
    import jax.numpy as jnp

    net = _tiny_net(compute_dtype=jnp.bfloat16)
    x = np.zeros((1, 64, 64, 3), np.float32)
    fn = net._device_detect_fn(1, 64, 64, 0.25, 0.45, 16)
    tally = cs.conv_dtype_tally(fn.lower(net.params, x).compile().as_text())
    # the two 3x3 convs (the CPU compiler turns the 1x1 head conv into a
    # dot, and runs bf16 convs in f32)
    assert tally == {("f32", "f32", "f32", "convolution"): 2}
    gpu_line = ('%p.1 = s8[1,8,8,4]{3,2,1,0} parameter(0)\n'
                '%w.2 = s8[1,1,4,4]{3,2,1,0} parameter(1)\n'
                '%cudnn-conv.3 = (f32[1,8,8,4]{3,2,1,0}, u8[0]{0}) '
                'custom-call(%p.1, %w.2), window={size=1x1}, '
                'custom_call_target="__cudnn$convForward"\n'
                '%t.4 = f32[4]{0} custom-call(%p.1, %w.2), '
                'custom_call_target="__cublas$gemm"\n')
    assert cs.conv_dtype_tally(gpu_line) == {
        ("s8", "s8", "f32", "__cudnn$convForward"): 1}


def test_within_floor_and_perturbed():
    x = np.linspace(0.1, 1.0, 1000, dtype=np.float32)
    xp = cs.perturbed(x)
    rel = np.abs(xp.astype(np.float64) / x - 1.0)
    assert rel.max() < 2.0 ** -22 and rel.min() > 0       # one ulp each
    assert np.array_equal(cs.perturbed(x), xp)          # seeded
    rel = np.abs(cs.perturbed(x, step=cs.TF32_STEP).astype(np.float64) / x
                 - 1.0)
    assert np.allclose(rel, 2.0 ** -11, rtol=1e-3)
    ok, k, worst = cs.within({0: 5e-4, 1: 0.04}, 0.05)
    assert ok and k == 1 and worst == 0.04
    ok, k, worst = cs.within({0: 0.3, 1: 0.04}, 0.05)
    assert not ok and k == 0 and worst == 0.3
    errs = cs.layer_errors([{"w": np.ones(3)}, {}, {"w": np.full(2, 2.0)}],
                           [{"w": np.ones(3)}, {}, {"w": np.ones(2)}])
    assert errs == {0: 0.0, 2: 1.0}
    # an update compares w, b and scales, never the rolling BN statistics
    p0 = [{"w": np.zeros(2), "mean": np.zeros(2)}]
    ref = [{"w": np.ones(2), "mean": np.ones(2)}]
    got = [{"w": np.ones(2), "mean": np.full(2, 5.0)}]
    assert cs.update_errors(p0, ref, got) == {0: 0.0}
