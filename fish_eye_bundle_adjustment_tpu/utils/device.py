"""What a measurement ran on: JAX's device and, on a GPU host, the card's
name and power limit as nvidia-smi reports them."""

from __future__ import annotations

import shutil
import subprocess


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    "not available" without nvidia-smi.  A subprocess: it never touches
    JAX, so it does not contend for the card."""
    if shutil.which("nvidia-smi") is None:
        return "not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else "not available"


def device_info() -> dict:
    """JAX's view of the devices (the keys the smoke's last line uses)."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def device_label() -> str:
    """One line naming the device a number was measured on."""
    info = device_info()
    label = f"{info['kind']} x{info['count']} ({info['platform']})"
    if info["platform"] == "gpu":
        label += f", nvidia-smi: {gpu_name_and_power_limit()}"
    return label
