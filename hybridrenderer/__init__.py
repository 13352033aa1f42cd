"""hybridrenderer — a real-time hybrid rendering framework in JAX.

Built on JAX/XLA with hand-written GPU kernels (a Triton tile raster, a
CUDA ray traversal) and the capabilities of the reference engine
CadenXc/HybridRenderer ("Chimera"): rasterized G-buffer + ray-traced
shadows/AO/reflections/diffuse GI, SVGF denoising, TAA, PBR shading,
render-graph pass composition, and forward/hybrid/ray-traced render paths.
See DESIGN.md for the architecture mapping.
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache: frame-function compiles are the
# dominant startup cost (the reference pays an analogous cost in driver
# SPIR-V→ISA compiles, amortized by its PipelineManager cache —
# PipelineManager.cpp:89-103; ours persists across processes).
import os as _os

import jax as _jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=_os.environ):
    """None when JAX_COMPILATION_CACHE_DIR is set (JAX then uses it and
    no directory is set in code), else ``<checkout>/.jax_cache``."""
    if environ.get(CACHE_ENV):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


if (_cache := compile_cache_dir()) is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from .core.config import RenderSettings
from .core.types import DisplayMode, MaterialType, RenderFlags, RenderPathType

__all__ = [
    "RenderSettings",
    "DisplayMode",
    "MaterialType",
    "RenderFlags",
    "RenderPathType",
]
