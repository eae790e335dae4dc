"""What the measurement runs on: JAX's devices and the card's name and
power limit. Every timing the repository prints names them, and a
measurement path that finds no GPU stops instead of timing the CPU."""

from __future__ import annotations

import os
import subprocess


def describe() -> dict:
    """{platform, kind, count} of JAX's devices, as JAX reports them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """describe(), or SystemExit(2) when JAX finds no GPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"mhc: needs a GPU, JAX found {dev['platform']} "
            f"({dev['kind']}); nothing was measured")
    return dev


def card() -> str:
    """`name, power.limit` of each card, as nvidia-smi gives them. A card
    set below its maximum power runs slower under load, so this goes
    beside every number."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in r.stdout.splitlines()
                     if line.strip())


def header() -> list[str]:
    """Lines naming the device, the JAX version, XLA_FLAGS and the card."""
    import jax
    dev = describe()
    return [f"device: {dev['platform']} {dev['kind']} x{dev['count']}",
            f"jax: {jax.__version__}",
            f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}",
            f"card: {card()}"]
