"""Defaults that depend on the platform the program runs on, in one table.

The CPU row is the reference-parity configuration: f32 convolutions at
`Precision.HIGHEST`, f32 interlayer activations and synchronous metrics, so
the golden gates against the darknet binary stay byte-stable.  The GPU row
is the product configuration on the card: bf16 conv operands with f32
accumulation, bf16 training residuals, three training steps in flight
before a loss is fetched, and the on-device decode + NMS serving program in
the CLI.  In the serving program XLA currently folds the bias and
activation into f32 cuDNN convolutions, which run as TF32 (PERF.md,
ROADMAP S4).

Every caller that used to branch on the backend asks `platform_defaults()`
instead.  A platform missing from the table is an error, not a fallback.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PlatformDefaults:
    compute_dtype: object      # conv/matmul operand dtype; None = f32 HIGHEST
    act16: bool                # bf16 interlayer training activations
    metric_lag: int            # training steps in flight before a fetch
    device_nms: bool           # CLI serving: on-device decode + NMS


_DEFAULTS = {
    "cpu": PlatformDefaults(compute_dtype=None, act16=False, metric_lag=0,
                            device_nms=False),
    "gpu": PlatformDefaults(compute_dtype=jnp.bfloat16, act16=True,
                            metric_lag=3, device_nms=True),
}


def platform_defaults(platform: str | None = None) -> PlatformDefaults:
    """The defaults for `platform` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return _DEFAULTS[platform]
    except KeyError:
        raise ValueError(
            f"no defaults for platform {platform!r}; known platforms: "
            f"{sorted(_DEFAULTS)}") from None
