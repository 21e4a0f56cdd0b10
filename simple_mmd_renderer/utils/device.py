"""The accelerator a measurement runs on.

Every timing in this repository comes from a GPU: `require_gpu` stops a
measurement script when JAX finds none, and `describe` names the device on
the script's output (JAX's platform, device kind and count, plus the card's
name and power limit from nvidia-smi, which reads no JAX state).
"""

from __future__ import annotations

import subprocess
import sys


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card), or the reason it is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def require_gpu() -> dict:
    """Exit with status 2 unless JAX's default device is a GPU; returns
    {"platform", "kind", "count"} of jax.devices()."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {devs[0].platform} "
                 f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def describe() -> str:
    """One line naming the device a measurement ran on."""
    d = require_gpu()
    return (f"device: {d['platform']} {d['kind']} x{d['count']}; card: "
            f"{card_line()}")
