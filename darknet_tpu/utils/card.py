"""Which card a measurement ran on.

Every timing this repository prints names its device: JAX's platform,
`device_kind` and device count, plus the card's name and power limit as
`nvidia-smi` reports them (a card capped below its maximum power runs
slower under load, so a number without its limit cannot be compared).
Measurement entry points call `require_gpu`: without a GPU they stop; they
never fall back to the CPU.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    pass


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line, or a note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc={out.returncode})"
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device JAX runs on, as {"platform", "kind", "count"}; raises
    NoGPUError unless that is a GPU."""
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default device is {d0.platform} "
            f"({d0.device_kind}); this entry point measures the card only")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}
