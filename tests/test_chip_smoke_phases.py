"""Rehearsal of chip_smoke.py's phases on the CPU: the same phase code, with
yolov4-tiny at 64x64 in place of yolov4-608, so wrong paths, arguments and
control flow show up before a run on the card.  The four-card phases run
over four of the virtual CPU devices."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def smoke(monkeypatch):
    from darknet_tpu import model_zoo

    def tiny_cfg(batch=64, subdiv=8):
        return model_zoo.yolov4_tiny_cfg(64, 64, batch=batch, subdiv=subdiv)

    monkeypatch.setattr(cs, "SIZE", 64)
    monkeypatch.setattr(cs, "yolov4_cfg_text", tiny_cfg)
    s = cs.Smoke()
    s.device = {"platform": "cpu", "kind": "cpu", "count": 4}
    return s


@pytest.mark.parametrize("name", ["serving", "heads", "nms", "train", "grad",
                                  "trace", "four_train", "four_serve"])
def test_phase_runs(smoke, name):
    smoke.phase(name, getattr(cs, f"phase_{name}"), smoke)
    assert not smoke.failed


def test_four_train_check_rejects_a_step_without_the_exchange(smoke):
    """A data-parallel step whose cards skip the gradient exchange, each
    updating from its own 16-row shard, fails phase_four_train's update
    check against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from darknet_tpu.graph.builder import build_graph
    from darknet_tpu.nn import params as paramlib
    from darknet_tpu.parallel import make_mesh
    from darknet_tpu.train.step import init_opt_state, make_train_step

    graph = build_graph(cs.dp_cfg(cs.yolov4_cfg_text()), train=True)
    net = graph.net
    assert net.decay == 0 and net.optimizer_batch == 64
    step = make_train_step(graph, jit=False, accum=net.subdiv)
    no_exchange = jax.jit(jax.shard_map(
        step, mesh=make_mesh(4), in_specs=(P(), P(), P("dp"), P("dp"), P(),
                                           P()),
        out_specs=P(), check_vma=False))
    p0 = paramlib.init_params(graph, seed=0)
    x, t = cs.synth_batch(np.random.default_rng(7), net.optimizer_batch,
                          cs.SIZE, graph.heads()[-1].max_boxes)
    args = (init_opt_state(graph, p0), x, t, jax.random.PRNGKey(0),
            jnp.float32(1e-3))
    p1 = jax.device_get(jax.jit(step)(p0, *args)[0])
    p_local = jax.device_get(no_exchange(p0, *args)[0])
    ok, _, worst = cs.within(cs.update_errors(p0, p1, p_local),
                             cs.DP_UPDATE_RTOL)
    assert not ok and worst > 10 * cs.DP_UPDATE_RTOL
