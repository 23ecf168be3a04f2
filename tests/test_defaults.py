"""Platform defaults (darknet_tpu/defaults.py) and the compile-cache
location (darknet_tpu/utils/cache.py)."""

import os

import jax
import jax.numpy as jnp
import pytest

from darknet_tpu.defaults import platform_defaults
from darknet_tpu.utils import cache as cachelib


def test_cpu_defaults_are_the_parity_configuration():
    # the golden gates depend on these staying exactly as they are
    d = platform_defaults("cpu")
    assert d.compute_dtype is None
    assert d.act16 is False
    assert d.metric_lag == 0
    assert d.device_nms is False


def test_gpu_defaults_are_the_product_configuration():
    d = platform_defaults("gpu")
    assert d.compute_dtype == jnp.bfloat16
    assert d.act16 is True
    assert d.metric_lag == 3
    assert d.device_nms is True


@pytest.mark.parametrize("platform", ["rocm", "METAL", "cuda", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no defaults for platform"):
        platform_defaults(platform)


def test_default_follows_jax_backend():
    assert platform_defaults() is platform_defaults(jax.default_backend())


def test_trainer_takes_defaults_from_the_table(monkeypatch):
    """DetectorTrainer leaves explicit arguments alone and fills the rest
    from the running platform's row."""
    from darknet_tpu import defaults as dmod
    from darknet_tpu.train import trainer as trmod

    monkeypatch.setattr(trmod, "platform_defaults",
                        lambda: dmod.platform_defaults("gpu"))
    cfg = ("[net]\nbatch=2\nsubdivisions=1\nwidth=32\nheight=32\n"
           "channels=3\n[convolutional]\nfilters=18\nsize=1\nstride=1\n"
           "pad=1\nactivation=linear\n[yolo]\nmask=0,1,2\n"
           "anchors=10,14, 23,27, 37,58\nclasses=1\nnum=3\n")
    t = trmod.DetectorTrainer(cfg, ["missing.png"], classes=1,
                              loader_processes=0, loader_threads=1,
                              log=lambda *a: None)
    t2 = trmod.DetectorTrainer(cfg, ["missing.png"], classes=1,
                               loader_processes=0, loader_threads=1,
                               compute_dtype=jnp.float32, act16=False,
                               metric_lag=0, log=lambda *a: None)
    try:
        assert (t.compute_dtype, t.act16, t.metric_lag) == (
            jnp.bfloat16, True, 3)
        assert (t2.compute_dtype, t2.act16, t2.metric_lag) == (
            jnp.float32, False, 0)
    finally:
        t.close()
        t2.close()


@pytest.fixture
def fresh_cache(monkeypatch):
    calls = []
    monkeypatch.setattr(cachelib, "_enabled", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_cache_honours_env_dir(fresh_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert cachelib.enable_persistent_cache() == str(tmp_path / "jc")
    # JAX reads the variable itself: no directory is set in code
    assert not [k for k, _ in fresh_cache
                if k == "jax_compilation_cache_dir"]


def test_cache_defaults_to_checkout(fresh_cache, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cachelib.enable_persistent_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", got) in fresh_cache
    assert os.path.isdir(got)
