"""Device mesh setup — the multi-chip substrate.

The reference is single-GPU (SURVEY §2.9); its only parallelism is SIMT +
frames-in-flight. Here the scale-out axis is data parallelism over
pixel rows: a 1-D ``Mesh('y')`` over the host's GPUs, image-space arrays
sharded on their Y (row) dimension, scene/BVH replicated (Sponza-scale
geometry is ~10s of MB — trivially fits each card). Stencil passes
(SVGF/TAA) read across shard boundaries; the GSPMD partitioner inserts
the halo exchanges (collective-permutes) automatically — a few rows of
pixels per step over NVLink.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int = None, axis: str = "y") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def row_sharding(mesh: Mesh, axis: str = "y") -> NamedSharding:
    """Shard dim-0 (image rows) across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
