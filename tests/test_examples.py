"""Smoke gates for examples/: each walkthrough runs end-to-end (tiny
iteration counts) in a subprocess, sharing one workdir like a user
following the README order.  Forces the CPU backend inside the
subprocess, whatever platforms the caller's environment names."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

_BOOTSTRAP = (
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "import sys, runpy;"
    "path = sys.argv[1]; sys.argv = sys.argv[1:];"
    "runpy.run_path(path, run_name='__main__')"
)


def _run(example: str, *args: str, timeout: int = 900) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", _BOOTSTRAP,
         os.path.join(EXAMPLES, example), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, (
        f"{example} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r.stdout


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shapes_demo"))


@pytest.fixture(scope="module")
def trained(workdir):
    out = _run("01_train_synthetic.py", "--workdir", workdir,
               "--iters", "12", "--images", "48")
    assert "final EMA loss:" in out and "mAP@0.5" in out
    assert os.path.exists(os.path.join(workdir, "backup",
                                       "shapes_final.weights"))
    return workdir


def test_02_detect(trained):
    out = _run("02_detect.py", "--workdir", trained, "--thresh", "0.01")
    assert "JSON:" in out
    assert os.path.exists(os.path.join(trained, "detections.png"))


def test_03_serving_export(trained):
    out = _run("03_serving_export.py", "--workdir", trained,
               "--batch", "4")
    assert "img/s" in out and "jax.export artifact" in out
    assert os.path.exists(os.path.join(trained, "shapes_serving.bin"))


def test_04_video_tracking(trained):
    out = _run("04_video_tracking.py", "--workdir", trained)
    assert "output video:" in out
    assert os.path.exists(os.path.join(trained, "tracking.mp4"))


def test_05_multichip(trained):
    out = _run("05_multichip.py", "--workdir", trained)
    assert "sharded serving: 8 images" in out
    assert "DP train step over 8 devices" in out
