"""Clip-stage inputs of the raster: the gather-free corner path (the
soup's per-corner tables transformed directly, as the G-buffer pass
does) against the shared-vertex gather path."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.ops import raster
from hybridrenderer.scene import scene as scene_mod

W, H = 128, 64


def test_soup_corner_clip_matches_gather():
    """Gather-free clip (corner tables transformed directly) is
    bit-exact vs the shared-vertex gather path."""
    data = scene_mod.stress_scene(num_objects=6, seed=7).build()
    cam = OrbitCamera(width=W, height=H, distance=25.0, pitch=0.4, yaw=0.3,
                      focal_point=(0, 2, 0)).step()
    vp = jnp.asarray(cam.proj) @ jnp.asarray(cam.view)
    clip = raster.transform_to_clip(data.vertices.world_position, vp)
    ref = raster.clip_triangles(clip, data.triangles.i0, data.triangles.i1,
                                data.triangles.i2, W, H)
    corners = jnp.stack(
        [raster.transform_to_clip(data.triangles.v0, vp),
         raster.transform_to_clip(data.triangles.v1, vp),
         raster.transform_to_clip(data.triangles.v2, vp)], axis=1)
    out = raster.clip_triangles(None, None, None, None, W, H,
                                corners=corners)
    np.testing.assert_array_equal(np.asarray(out.valid),
                                  np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(out.sxy), np.asarray(ref.sxy))
    np.testing.assert_array_equal(np.asarray(out.z), np.asarray(ref.z))
    np.testing.assert_array_equal(np.asarray(out.tri_id),
                                  np.asarray(ref.tri_id))
