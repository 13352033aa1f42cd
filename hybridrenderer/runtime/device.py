"""The device a measurement ran on.

Every timed result names its device; a measurement path that finds no
GPU fails instead of timing the CPU.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import jax

# XLA flags the GPU launchers (bench.py, chip_smoke.py) run with.
# Autotuning level 0 uses XLA's default kernel choices instead of timing
# candidates per shape: a 1080p frame compiles in ~35 s instead of ~86 s
# on an H100 (PERF.md); the frame has no large matrix products.
GPU_XLA_FLAGS = ("--xla_gpu_autotune_level=0",)


def set_launcher_flags() -> str:
    """Add GPU_XLA_FLAGS to XLA_FLAGS (a flag the caller already set
    wins). Call before JAX initializes a backend. Returns XLA_FLAGS."""
    flags = os.environ.get("XLA_FLAGS", "")
    for f in GPU_XLA_FLAGS:
        if f.split("=")[0] not in flags:
            flags = f"{flags} {f}".strip()
    os.environ["XLA_FLAGS"] = flags
    return flags


def require_gpu():
    """The first JAX device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {dev.platform!r} ({dev.device_kind}); "
            "timings are only taken on the GPU")
    return dev


def describe() -> dict:
    """Platform, kind and count of the JAX devices."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), the card's identity beside every number."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
