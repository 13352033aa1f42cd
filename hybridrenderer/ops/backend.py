"""The one place that decides which implementation of a layer runs.

On a GPU the hand-written kernels run (ops/raster_tile.py through
Triton, ops/trace_cuda.py through the FFI). On the CPU the plain jnp
references run — that is how the tests exercise the renderer. Any other
platform is an error: there is no silent fallback.

Settings fields ``raster_backend`` / ``trace_backend`` take "auto" (the
platform decides), "jnp" (the reference everywhere) or "kernel" (the
kernel; on the CPU only through an explicit interpret-mode call).
"""
from __future__ import annotations

import jax

CHOICES = ("auto", "jnp", "kernel")


def platform() -> str:
    return jax.devices()[0].platform


def resolve(requested: str) -> str:
    """"auto" | "jnp" | "kernel" → "jnp" or "kernel"."""
    if requested not in CHOICES:
        raise ValueError(f"unknown backend {requested!r}; one of {CHOICES}")
    if requested != "auto":
        return requested
    p = platform()
    if p == "gpu":
        return "kernel"
    if p == "cpu":
        return "jnp"
    raise RuntimeError(
        f"unsupported JAX platform {p!r}: kernels run on 'gpu', the jnp "
        "references on 'cpu'")
