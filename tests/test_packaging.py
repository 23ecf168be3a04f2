"""Packaging gate: a built wheel must carry everything an installed copy
needs — in particular the native host-kernel source (package data) that
a plain `packages.find` silently drops (caught once already)."""

import glob
import os
import subprocess
import sys
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("wheel"))
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-w", out, REPO],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"pip wheel unavailable: {r.stderr[-300:]}")
    whls = glob.glob(os.path.join(out, "darknet_tpu-*.whl"))
    assert len(whls) == 1, whls
    return whls[0]


def test_wheel_contents(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    required = [
        "darknet_tpu/_native/yolo_host.cpp",   # native kernels (pkg data)
        "darknet_tpu/data/synth.py",
        "darknet_tpu/apps/cli.py",
        "darknet_tpu/defaults.py",
        "darknet_tpu/parallel/pipeline.py",
    ]
    for req in required:
        assert any(n == req for n in names), f"{req} missing from wheel"
    # console script registered (yolo-core = apps.cli:main)
    meta = [n for n in names if n.endswith("entry_points.txt")]
    assert meta, "no entry_points.txt in wheel"
    txt = zipfile.ZipFile(wheel).read(meta[0]).decode()
    assert "yolo-core = darknet_tpu.apps.cli:main" in txt
