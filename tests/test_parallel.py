"""Data-parallel tests on the emulated 8-device CPU mesh: DP step runs,
and its math matches the single-device step (per-step psum DP is exact)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as paramlib
from darknet_tpu.parallel import (make_dp_train_step, make_mesh, replicate,
                                  shard_batch)
from darknet_tpu.train.step import init_opt_state, make_train_step

CFG = """[net]
batch=8
subdivisions=1
width=32
height=32
channels=3
learning_rate=0.01
momentum=0.9
decay=0.0005
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky
[convolutional]
filters=16
size=1
activation=linear
[yolo]
mask=0,1
num=2
classes=3
anchors=8,8, 16,16
iou_loss=ciou
max_delta=5
"""


@pytest.fixture(scope="module")
def setup():
    g = build_graph(CFG, train=True)
    params = paramlib.init_params(g, seed=0)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    truths = np.zeros((8, 4, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    return g, params, x, truths


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_dp_step_matches_single_device(setup):
    g, params, x, truths = setup
    key = jax.random.PRNGKey(0)
    lr = jnp.float32(0.01)

    # single-device
    step1 = make_train_step(g, donate=False)
    opt1 = init_opt_state(g, params)
    p1, o1, c1, m1 = step1(params, opt1, jnp.asarray(x), jnp.asarray(truths),
                           key, lr)

    # 8-device DP
    mesh = make_mesh(8)
    pr = replicate(mesh, params)
    opt8 = replicate(mesh, init_opt_state(g, params))
    step8 = make_dp_train_step(g, mesh, donate=False)
    p8, o8, c8, m8 = step8(pr, opt8, shard_batch(mesh, x),
                           shard_batch(mesh, truths),
                           replicate(mesh, key), replicate(mesh, lr))

    np.testing.assert_allclose(float(c1), float(c8), rtol=1e-4)
    for a, b in zip(p1, p8):
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=2e-4, atol=2e-6)
    assert int(m1["count"]) == int(m8["count"]) == 8


def test_weight_averaging_compat_mode(setup):
    """Reference SyncNetworks semantics: independent replicas + periodic
    weight averaging; replicas agree after sync and training progresses."""
    import jax.numpy as jnp

    from darknet_tpu.parallel.weight_avg import (make_weight_avg_train_step,
                                                 replicate_params)
    from darknet_tpu.train.step import init_opt_state

    g, params, x, truths = setup
    R = 2
    step, sync = make_weight_avg_train_step(g, R)
    params_r = replicate_params(params, R)
    opt_r = replicate_params(init_opt_state(g, params), R)

    xr = jnp.asarray(x.reshape(R, 4, 32, 32, 3))
    tr = jnp.asarray(truths.reshape(R, 4, 4, 5))
    key = jax.random.PRNGKey(0)
    costs = []
    for it in range(8):
        params_r, opt_r, cost, _m = step(params_r, opt_r, xr, tr, key,
                                         jnp.float32(0.01))
        costs.append(float(jnp.sum(cost)))
        if (it + 1) % 4 == 0:              # sync_interval=4 (detector.cpp:196)
            params_r = sync(params_r)

    # replicas identical after sync
    for p in params_r:
        for k in p:
            a = np.asarray(p[k])
            np.testing.assert_allclose(a[0], a[1], rtol=1e-6, atol=1e-7)
    assert costs[-1] < costs[0]
    # replicas diverge between syncs (they saw different shards)
    params_r, opt_r, _, _ = step(params_r, opt_r, xr, tr, key,
                                 jnp.float32(0.01))
    diverged = any(
        not np.allclose(np.asarray(p[k])[0], np.asarray(p[k])[1])
        for p in params_r for k in p)
    assert diverged


def test_dryrun_multichip_driver_contract():
    """dryrun_multichip(8) called in a process where jax is already
    initialized on a 1-device platform must self-bootstrap an 8-device
    CPU subprocess — no pre-set XLA_FLAGS, no conftest help.

    Upgrades /root/reference/src/network_kernels.cu:398-484 (SyncNetworks).
    """
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # strip everything the conftest or the caller might have set
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env.pop("_DARKNET_TPU_DRYRUN_CHILD", None)
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "assert len(jax.devices()) == 1, jax.devices(); "
        f"import sys; sys.path.insert(0, {repo!r}); "
        "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                          capture_output=True, text=True, timeout=560)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mesh OK" in proc.stdout, proc.stdout
