"""Test harness: run JAX on a virtual 8-device CPU mesh.

Mirrors SURVEY.md §4's strategy — multi-device (DP/psum) logic must run in
CI without accelerators, via `--xla_force_host_platform_device_count` host
emulation.  `JAX_PLATFORMS` defaults to cpu.  A test of code that runs only
on a card takes the `gpu` marker and the `gpu_device` fixture; on a card:
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("DARKNET_TPU_NO_GUI", "1")   # no imshow windows in CI
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# --- test tiers -------------------------------------------------------
# quick tier:  pytest -m "not slow"        (< ~2 min; the inner loop)
# full suite:  pytest                      (~30 min: golden gates vs the
#              compiled reference binary, 8-device mesh tests, train loops)
# Whole modules are tiered here so the list stays auditable in one place;
# individual tests can still opt in/out with @pytest.mark.slow.
SLOW_MODULES = {
    "test_reference_fuzz",            # 69+53 golden fuzz seeds vs binary
    "test_reference_parity",          # activation-parity gates vs binary
    "test_reference_map_parity",      # end-to-end mAP gates vs binary
    "test_reference_training_parity", # TrainNetworkDatum golden gates
    "test_reference_trainloop",       # 600-iter train A/Bs vs binary
    "test_multihost",                 # 2-process gloo distributed gates
    "test_parallel",                  # 8-device mesh DP exact-match
    "test_pipeline",                  # GPipe stage planning + training
    "test_tensor_parallel",           # tp sharding exact-match
    "test_spatial",                   # sp halo sharding
    "test_examples",                  # end-to-end example subprocesses
    "test_train_step",                # full train-step compiles
    "test_checkpoint",                # trainer resume loops
    "test_map",                       # batched validator runs
    "test_capi",                      # compiles + runs the C ABI client
    "test_packaging",                 # builds a wheel
    "test_mosaic_golden",             # full aug-pipeline golden cases
    "test_device_detect",             # device serving program compiles
    "test_int8",                      # int8 calibration + mAP gate
    "test_network",                   # resize/re-jit multi-compiles
    "test_data",                      # loader process-pool round-trips
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: golden gates, mesh tests, train loops "
                   "(excluded from the quick tier: pytest -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (take the gpu_device fixture, "
                   "which skips elsewhere)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def fixtures_dir():
    return FIXTURES


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX's default device is not one.
    Decided here, at run time — never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device: {dev.platform});"
                    " run: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu "
                    "tests/")
    return dev
