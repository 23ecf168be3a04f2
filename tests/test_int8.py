"""int8 quantized inference path (ops/conv.conv_block_int8) — the
analogue of the reference's XNOR/binary fast path (gemm.c:1334,
convolutional_layer.cpp:1005-1120)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.nn.emit import make_forward

CFG = """[net]
batch=1
subdivisions=1
width=32
height=32
channels=3
[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=160
size=1
stride=1
pad=1
activation=leaky
[convolutional]
filters=6
size=1
activation=linear
[yolo]
mask=0
num=1
classes=1
anchors=16,16
"""


@pytest.fixture(scope="module")
def setup():
    g = build_graph(CFG)
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=4))
    x = np.random.default_rng(0).uniform(
        0, 1, (2, 32, 32, 3)).astype(np.float32)
    return g, params, x


def test_quantize_eligibility(setup):
    g, params, _ = setup
    qp = paramlib.quantize_conv_params(g, params)
    assert "w_q" not in qp[0]          # c=3 < 128: too small
    assert "w_q" in qp[1] and "w_q" in qp[2]
    assert "w_q" not in qp[3]          # head conv stays full precision
    assert qp[1]["w_q"].dtype == np.int8
    assert qp[1]["w_scale"].shape == (128,)
    # quantization is per-output-channel symmetric absmax
    w = np.asarray(params[1]["w"])
    rec = qp[1]["w_q"].astype(np.float32) * qp[1]["w_scale"]
    assert np.max(np.abs(rec - w)) <= np.max(np.abs(w)) / 127.0 + 1e-7


def test_int8_forward_close_to_f32(setup):
    g, params, x = setup
    qp = paramlib.quantize_conv_params(g, params)
    ref = make_forward(g, fused_bn=True)(params, x)
    got = make_forward(g, fused_bn=True)(qp, x)
    a = np.asarray(ref["heads"][0])
    b = np.asarray(got["heads"][0])
    # 8-bit dynamic quantization over 2 conv layers: percent-level error
    assert np.max(np.abs(a - b)) < 0.15
    assert np.mean(np.abs(a - b)) < 0.02
    # and decidedly NOT identical (the int8 path actually ran)
    assert np.max(np.abs(a - b)) > 1e-5


def test_calibration_probe_and_static_scales(setup):
    """probe_conv_absmax records true per-conv input absmax; static
    x_scale calibrated on the same batch reproduces the dynamic path."""
    g, params, x = setup
    qp = paramlib.quantize_conv_params(g, params)
    absmax = paramlib.calibrate_conv_input_scales(g, qp, [x])
    # every conv observed, and layer 0's entry is the input absmax
    assert set(absmax) == {i for i, l in enumerate(g.layers)
                           if l.kind == "convolutional"}
    assert absmax[0] == pytest.approx(float(np.max(np.abs(x))), rel=1e-6)

    sp = paramlib.apply_conv_input_scales(qp, absmax)
    assert "x_scale" not in sp[0] and "x_scale" in sp[1]
    assert "x_scale" not in sp[3]            # head conv not quantized
    dyn = make_forward(g, fused_bn=True)(qp, x)
    sta = make_forward(g, fused_bn=True)(sp, x)
    # same batch => same scales => near-identical outputs
    np.testing.assert_allclose(np.asarray(sta["heads"][0]),
                               np.asarray(dyn["heads"][0]),
                               rtol=1e-4, atol=1e-5)


def test_static_scales_clip_outliers(setup):
    """Inputs beyond the calibrated range clip (saturate) instead of
    rescaling — the defining static-quantization behavior."""
    g, params, x = setup
    qp = paramlib.quantize_conv_params(g, params)
    absmax = paramlib.calibrate_conv_input_scales(g, qp, [x])
    sp = paramlib.apply_conv_input_scales(qp, absmax)
    hot = x * 10.0                       # 10x outside calibration range
    dyn = make_forward(g, fused_bn=True)(qp, hot)
    sta = make_forward(g, fused_bn=True)(sp, hot)
    d = np.max(np.abs(np.asarray(dyn["heads"][0]) -
                      np.asarray(sta["heads"][0])))
    assert d > 1e-3                      # visibly different: clipping real


def test_int8_map_accuracy(tmp_path):
    """End-to-end accuracy of the quantized path: mAP over a synthetic
    labeled set with a briefly-trained net — f32 vs dynamic int8 vs
    static-calibrated int8 must agree closely (the deployment guarantee
    behind the --int8 bench headline)."""
    import cv2
    import jax
    import jax.numpy as jnp

    from darknet_tpu.eval.map import validate_detector
    from darknet_tpu.nn.network import Network
    from darknet_tpu.train.step import init_opt_state, make_train_step
    from darknet_tpu.weights import io as wio

    size, classes = 64, 2
    cfg = f"""[net]
batch=8
subdivisions=1
width={size}
height={size}
channels=3
[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
activation=mish
[convolutional]
filters=21
size=1
activation=linear
[yolo]
mask=0,1,2
num=3
classes={classes}
anchors=6,6, 12,12, 24,16
"""
    cfg_path = str(tmp_path / "q.cfg")
    with open(cfg_path, "w") as f:
        f.write(cfg)

    rng = np.random.default_rng(9)
    paths = []
    truths = np.zeros((16, 90, 5), np.float32)
    xs = []
    for i in range(16):
        img = rng.integers(0, 60, (size, size, 3), np.uint8)
        cx, cy, w, h = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), .3, .3
        x0, y0 = int((cx - w / 2) * size), int((cy - h / 2) * size)
        cls = int(rng.integers(0, classes))
        img[y0:y0 + int(h * size), x0:x0 + int(w * size)] = \
            (220, 40, 40) if cls == 0 else (40, 220, 40)
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, img)
        with open(str(tmp_path / f"im{i}.txt"), "w") as f:
            f.write(f"{cls} {cx} {cy} {w} {h}\n")
        paths.append(p)
        truths[i, 0] = [cx, cy, w, h, cls]
        xs.append(img[..., ::-1].astype(np.float32) / 255.0)
    x = np.stack(xs)

    from darknet_tpu.graph.builder import build_graph
    g = build_graph(cfg, train=True)
    params = paramlib.init_params(g, seed=3)
    opt = init_opt_state(g, params)
    step = make_train_step(g)
    for it in range(2):
        for lo in range(0, 16, 8):
            params, opt, cost, _m = step(
                params, opt, jnp.asarray(x[lo:lo + 8]),
                jnp.asarray(truths[lo:lo + 8]),
                jax.random.PRNGKey(it * 2 + lo), jnp.float32(1e-3))
    weights = str(tmp_path / "q.weights")
    wio.save_weights(g, params, weights, seen=32)

    def run_map(calibrate=False, **kw):
        net = Network.from_cfg(cfg_path, weights=weights, fuse=True, **kw)
        if calibrate:
            net.calibrate_int8(x[:8])
        r = validate_detector(net, paths, classes=classes,
                              iou_thresh=0.5, batch=4, progress=False)
        return r.map, net

    m_f32, _ = run_map()
    m_dyn, _ = run_map(int8=True)
    m_sta, net_sta = run_map(int8=True, calibrate=True)
    assert any("x_scale" in p for p in net_sta.params)
    # a few training steps give structured (nonzero-mAP) predictions
    assert m_f32 > 0
    assert abs(m_dyn - m_f32) < 0.05, (m_dyn, m_f32)
    assert abs(m_sta - m_dyn) < 0.02, (m_sta, m_dyn)


def test_int8_network_facade(tmp_path, setup):
    from darknet_tpu.nn.network import Network

    cfg_path = str(tmp_path / "q.cfg")
    with open(cfg_path, "w") as f:
        f.write(CFG)
    net = Network.from_cfg(cfg_path, seed=4, int8=True)
    assert any("w_q" in p for p in net.params)
    dets = net.detect(np.zeros((32, 32, 3), np.float32), thresh=0.01)
    assert isinstance(dets, list)
    # static calibration through the facade
    rng = np.random.default_rng(3)
    net.calibrate_int8([rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
                        for _ in range(2)])
    assert any("x_scale" in p for p in net.params)
    dets2 = net.detect(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                       thresh=0.01)
    assert isinstance(dets2, list)


def test_calibration_share_index_folds_site_ranges():
    """A share_index conv reads the SOURCE layer's params (emit.py), so
    static calibration must fold every call site's input range into the
    source's x_scale (max — no saturation at any site)."""
    cfg = """[net]
batch=1
subdivisions=1
width=16
height=16
channels=3
[convolutional]
filters=128
size=1
activation=linear
[convolutional]
filters=128
size=1
activation=linear
[convolutional]
filters=128
size=1
share_index=-1
activation=linear
[convolutional]
filters=6
size=1
activation=linear
[yolo]
mask=0
num=1
classes=1
anchors=16,16
"""
    g = build_graph(cfg)
    params = paramlib.fuse_conv_batchnorm(g, paramlib.init_params(g, seed=7))
    qp = paramlib.quantize_conv_params(g, params)
    assert "w_q" in qp[1] and "w_q" not in qp[2]     # site shares, no own w
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    absmax = paramlib.calibrate_conv_input_scales(g, qp, [x])
    assert 1 in absmax and 2 in absmax
    sp = paramlib.apply_conv_input_scales(qp, absmax, graph=g)
    want = max(absmax[1], absmax[2]) / 127.0
    assert float(sp[1]["x_scale"]) == pytest.approx(want, rel=1e-6)
    # without the graph, the source only sees its own site's range
    sp_no = paramlib.apply_conv_input_scales(qp, absmax)
    assert float(sp_no[1]["x_scale"]) == pytest.approx(
        absmax[1] / 127.0, rel=1e-6)


def test_calibration_cache_roundtrip(tmp_path, setup):
    """save_calibration/load_calibration: a fresh net loading the cache
    gets bit-identical scales (and therefore identical detections) to
    the net that calibrated — calibrate once, serve many."""
    from darknet_tpu.nn.network import Network

    cfg_path = str(tmp_path / "q.cfg")
    with open(cfg_path, "w") as f:
        f.write(CFG)
    rng = np.random.default_rng(9)
    calib = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
             for _ in range(3)]
    probe = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)

    net_a = Network.from_cfg(cfg_path, seed=4, int8=True)
    with pytest.raises(ValueError):
        net_a.save_calibration(str(tmp_path / "nope.npz"))
    net_a.calibrate_int8(calib)
    # a bare path (no .npz) must round-trip too: np.savez appends the
    # suffix to plain paths, which would break `-calib_file scales.cache`
    cache = str(tmp_path / "scales.cache")
    net_a.save_calibration(cache)
    assert os.path.exists(cache) and not os.path.exists(cache + ".npz")

    net_b = Network.from_cfg(cfg_path, seed=4, int8=True)
    net_b.load_calibration(cache)
    for pa, pb in zip(net_a.params, net_b.params):
        for k in pa:
            np.testing.assert_array_equal(np.asarray(pa[k]),
                                          np.asarray(pb[k]),
                                          err_msg=k)
    da = net_a.detect(probe, thresh=0.01)
    db = net_b.detect(probe, thresh=0.01)
    assert len(da) == len(db)
    for a, b in zip(da, db):
        np.testing.assert_array_equal(a.bbox, b.bbox)


def test_int8_serving_composes_with_mesh(tmp_path):
    """int8 (static-calibrated) production serving over a dp mesh equals
    the single-device int8 program — the bench headline config is
    mesh-shardable as-is."""
    import jax  # noqa: F401

    from darknet_tpu.nn.network import Network
    from darknet_tpu.parallel import make_mesh

    cfg_path = str(tmp_path / "q.cfg")
    with open(cfg_path, "w") as f:
        f.write(CFG)
    rng = np.random.default_rng(5)
    net = Network.from_cfg(cfg_path, seed=4, int8=True)
    net.calibrate_int8([rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
                        for _ in range(2)])
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)

    ref = net._device_detect_fn(8, 32, 32, 0.01, 0.45, 16)(net.params, x)
    tb, ov, probs = net._device_detect_fn(
        8, 32, 32, 0.01, 0.45, 16, mesh=make_mesh(8))(net.params, x)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(ref[0]),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ov), np.asarray(ref[1]),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(ref[2]),
                               rtol=2e-5, atol=2e-6)


def test_int8_export_serving_roundtrip(tmp_path):
    """The TensorRT-engine analogue composes with the int8 path: a
    quantized + statically-calibrated serving program exports through
    jax.export and reproduces detect_batch_device without cfg/weights."""
    import numpy as np

    from darknet_tpu.nn.network import Network

    cfg = ("[net]\nbatch=1\nsubdivisions=1\nwidth=32\nheight=32\n"
           "channels=3\n"
           "[convolutional]\nfilters=128\nsize=3\nstride=2\npad=1\n"
           "activation=leaky\n"
           "[convolutional]\nbatch_normalize=1\nfilters=128\nsize=3\n"
           "stride=2\npad=1\nactivation=mish\n"
           "[convolutional]\nfilters=20\nsize=1\nactivation=linear\n"
           "[yolo]\nmask=0,1\nnum=2\nclasses=5\nanchors=10,14, 23,27\n")
    net = Network.from_cfg(cfg, int8=True, seed=2)
    assert any("w_q" in p for p in net.params)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    net.calibrate_int8(x)
    d1 = net.detect_batch_device(x, thresh=0.1, top_k=16)
    art = str(tmp_path / "s.bin")
    net.export_serving(art, batch=2, thresh=0.1, top_k=16)
    tb, ov, pr = Network.run_exported_serving(art, x)
    d2 = Network.device_out_to_dets(tb, ov, pr)
    assert [len(a) for a in d1] == [len(b) for b in d2]
    for a, b in zip(d1[0], d2[0]):
        np.testing.assert_allclose(a.bbox, b.bbox, atol=1e-6)


def test_int8_calibration_survives_resize(tmp_path):
    """Static scales are per-conv and resolution-independent: a resized
    Network keeps the quantized params AND the calibration bookkeeping
    (save_calibration after multi-scale resize must work)."""
    import numpy as np

    from darknet_tpu.nn.network import Network

    cfg = ("[net]\nbatch=1\nsubdivisions=1\nwidth=32\nheight=32\n"
           "channels=3\n"
           "[convolutional]\nfilters=128\nsize=3\nstride=2\npad=1\n"
           "activation=leaky\n"
           "[convolutional]\nbatch_normalize=1\nfilters=128\nsize=3\n"
           "stride=2\npad=1\nactivation=mish\n"
           "[convolutional]\nfilters=20\nsize=1\nactivation=linear\n"
           "[yolo]\nmask=0,1\nnum=2\nclasses=5\nanchors=10,14, 23,27\n")
    net = Network.from_cfg(cfg, int8=True, seed=2)
    rng = np.random.default_rng(0)
    net.calibrate_int8(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    net2 = net.resize(64, 64)
    assert any("w_q" in p for p in net2.params)
    net2.save_calibration(str(tmp_path / "c.cache"))   # must not raise
    d = net2.detect_batch_device(
        rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
        thresh=0.05, top_k=16)
    assert len(d[0]) > 0
