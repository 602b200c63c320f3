"""The device a measurement runs on: refuse to run without a GPU, and name
the card in the output."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> None:
    """Exit with a message unless JAX's first device is a GPU. A measurement
    on another platform is not a measurement of this system, so there is no
    fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this run needs a GPU and has no CPU fallback"
        )


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def print_device_lines() -> None:
    """Print the device as JAX sees it, the card's name and power limit as
    ``nvidia-smi`` reports them (a child process that stays off JAX), the
    JAX version and the compile-cache directory in use."""
    info = device_info()
    print(f"device: {info['platform']} {info['kind']} x{info['count']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(line)
    print(f"jax: {jax.__version__}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
