"""Golden-image regression tests (SURVEY §4: substitute for the
reference's eyeball-driven display modes)."""
import os

import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.runtime.output import read_png, to_u8
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_cube_forward_golden():
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL,
                       raster_backend="jnp")
    r = Renderer(s, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45, yaw=0.6,
                      focal_point=(0, 0.7, 0))
    img = to_u8(r.render_np(cam.step()))
    golden = read_png(os.path.join(GOLDEN_DIR, "cube_forward_64.png"))
    diff = np.abs(img.astype(int) - golden.astype(int))
    # allow small cross-platform float drift, catch structural changes
    assert np.percentile(diff, 99) <= 2, f"p99 diff {np.percentile(diff, 99)}"
    assert diff.max() <= 16, f"max diff {diff.max()}"


def test_cube_forward_golden_offedge():
    """Device-independent golden gate: whatever
    backend runs this, any error beyond the CPU tolerance must be
    confined to (dilated) triangle-boundary pixels — the only place
    fma/tie-break winner flips can live. Off-edge error above the CPU
    max-tolerance is a genuine raster bug and fails here."""
    import jax.numpy as jnp

    from hybridrenderer.core import maths
    from hybridrenderer.ops import raster as raster_ops
    from hybridrenderer.ops.image import tri_boundary_mask

    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL,
                       raster_backend="jnp")
    r = Renderer(s, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45, yaw=0.6,
                      focal_point=(0, 0.7, 0))
    cs = cam.step()
    img = to_u8(r.render_np(cs))
    golden = read_png(os.path.join(GOLDEN_DIR, "cube_forward_64.png"))
    err = np.abs(img.astype(int) - golden.astype(int)).max(axis=-1)

    planes = maths.frustum_from_viewproj(
        jnp.asarray(cs.proj) @ jnp.asarray(cs.view))
    culled = maths.aabb_outside_frustum(
        data.instances.aabb_min, data.instances.aabb_max, planes)
    vis = raster_ops.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, cs, 64, 64, jitter_enabled=False,
        tri_mask=~culled[data.triangles.instance],
        single_sided=data.triangles.single_sided)
    edge = tri_boundary_mask(vis.tri_id, dilate=1)
    off = err[~edge]
    assert off.size and off.max() <= 16, \
        f"off-edge err {off.max()} exceeds the CPU tolerance"
