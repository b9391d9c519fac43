"""What the program runs on: JAX's devices and the card's power limit.

Every measurement names its device, and a measurement path that finds no
GPU stops instead of timing the CPU (bench.py, chip_smoke.py).
"""

from __future__ import annotations

import subprocess


def describe():
    """{"platform", "kind", "count"} of the devices JAX runs on."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def device_line():
    """'platform device_kind xcount' of the devices JAX runs on."""
    d = describe()
    return f"{d['platform']} {d['kind']} x{d['count']}"


def require_gpu(prog):
    """The device description; exits with a message unless JAX's first
    device is a GPU."""
    d = describe()
    if d["platform"] != "gpu":
        raise SystemExit(f"{prog}: needs a GPU, but JAX's devices are "
                         f"{d['platform']} ({d['kind']}); refusing to "
                         "measure anything else")
    return d


def card_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` lines, as printed."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
