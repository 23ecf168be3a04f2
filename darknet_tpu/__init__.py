"""darknet_tpu — a JAX re-implementation of the yolo-core capability set.

The reference (Ravicmoon/darknet, a trimmed AlexeyAB/darknet fork) is an
interpreter over a layer array with hand-written CPU/CUDA kernels.  This
package is a *compiler* from the same artifact contracts — the `.cfg` model
dialect, the binary `.weights` format and the `.data` dataset descriptor —
into a single XLA program, jitted once and executed on an NVIDIA GPU (or,
for the tests and the reference-parity gates, on the CPU).

Public surface (mirrors the capability of `yolo_core.h:625-663`):

    Network.from_cfg(cfg, weights=..., train=...)   # LoadNetwork
    Network.predict(image)                          # NetworkPredict + boxes
    Network.save_weights(path)                      # SaveWeights
    fuse_conv_batchnorm(...)                        # FuseConvBatchNorm
"""

from darknet_tpu.version import __version__, WEIGHTS_VERSION

# The public surface resolves lazily (PEP 562) so that importing any
# submodule — in particular data.loader inside spawned loader workers —
# does not drag in jax through nn.network.  Workers stay numpy+cv2-only
# and `import darknet_tpu` for config-only use stays instant.
_LAZY = {
    "parse_cfg_text": "darknet_tpu.config.cfg",
    "parse_cfg_file": "darknet_tpu.config.cfg",
    "Section": "darknet_tpu.config.cfg",
    "Metadata": "darknet_tpu.config.metadata",
    "build_graph": "darknet_tpu.graph.builder",
    "NetConfig": "darknet_tpu.graph.ir",
    "LayerIR": "darknet_tpu.graph.ir",
    "Network": "darknet_tpu.nn.network",
    "fuse_conv_batchnorm": "darknet_tpu.nn.params",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        val = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module 'darknet_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    "__version__",
    "WEIGHTS_VERSION",
    "parse_cfg_text",
    "parse_cfg_file",
    "Section",
    "Metadata",
    "build_graph",
    "NetConfig",
    "LayerIR",
    "Network",
    "fuse_conv_batchnorm",
]
