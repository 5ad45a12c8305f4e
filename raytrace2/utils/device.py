"""The accelerator a measurement runs on.

Every number a benchmark or smoke run prints names its device: JAX's
platform, device kind and device count, and the card's name and power
limit as nvidia-smi reports them (a card set below its maximum power runs
slower under load). A measurement path that finds no GPU stops; it never
carries on on the CPU.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX found no GPU."""


def require_gpu():
    """The first JAX device; raises NoGpuError unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default device is {dev.platform} "
            f"({dev.device_kind}); this measurement runs only on a GPU")
    return dev


def describe(dev=None) -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    import jax

    dev = dev or jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the cards, one line
    per card joined by '; ' ("not available" where nvidia-smi is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def peak_bytes(dev=None) -> int | None:
    """``peak_bytes_in_use`` of a device since its process started."""
    import jax

    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")
