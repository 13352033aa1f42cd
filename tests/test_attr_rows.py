"""Pre-joined attribute rows (scene.attr_rows) — equality vs the narrow
per-pixel/per-ray gather paths, and refresh on dynamic updates.

The joined fetch performs the same per-component lerp arithmetic as the
narrow path, so results must match exactly (not just within tolerance).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.graph.params import FrameParams
from hybridrenderer.ops import gbuffer, raster
from hybridrenderer.ops.trace import SceneTracer
from hybridrenderer.scene import dynamic, schema
from hybridrenderer.scene import scene as scene_mod


class _Ctx:
    pass


def _env(key, value):
    old = os.environ.get(key)
    if value is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = value
    return old


def test_gbuffer_join_matches_pixel():
    sc = scene_mod.cube_scene()
    data = sc.build()
    assert data.attr_rows is not None
    assert data.attr_rows.shape == (data.triangles.count, 84)
    cam = OrbitCamera(width=64, height=64, distance=6.0, pitch=0.5,
                      focal_point=(0, 0.75, 0))
    state = cam.step()
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, 64, 64, jitter_enabled=False)
    old = _env("GBUFFER_FETCH", "pixel")
    try:
        gb_pixel = gbuffer.build_gbuffer(vis, data, state)
    finally:
        _env("GBUFFER_FETCH", old)
    gb_join = gbuffer.build_gbuffer(vis, data, state)
    for f in dataclasses.fields(gb_join):
        a = np.asarray(getattr(gb_join, f.name))
        b = np.asarray(getattr(gb_pixel, f.name))
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_shade_join_matches_pixel():
    sc = scene_mod.cornell_scene()   # emissive light exercises NEE
    data = sc.build()
    tracer = SceneTracer.build(data)
    ctx = _Ctx()
    ctx.settings = RenderSettings(
        width=32, height=32, path=RenderPathType.HYBRID,
        flags=RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE)
    ctx.params = FrameParams(
        sun_direction=data.sun.direction, sun_color=data.sun.color,
        sun_intensity=data.sun.intensity,
        ambient_strength=data.sun.ambient, exposure=jnp.float32(1.0),
        svgf_phi=jnp.asarray([4.0, 128.0, 0.02, 0.0], jnp.float32),
        frame_index=jnp.uint32(3))

    cam = OrbitCamera(width=32, height=32, distance=3.0,
                      focal_point=(0, 1.0, 0)).step()
    ys, xs = jnp.meshgrid(jnp.linspace(-0.4, 0.4, 32),
                          jnp.linspace(-0.4, 0.4, 32), indexing="ij")
    origin = jnp.broadcast_to(jnp.asarray(list(cam.position)),
                              (32, 32, 3))
    target = jnp.stack([xs, 1.0 + ys, jnp.zeros_like(xs)], -1)
    direction = target - origin
    direction = direction / jnp.linalg.norm(direction, axis=-1,
                                            keepdims=True)

    old = _env("SHADE_FETCH", "pixel")
    try:
        rgb_p, dist_p = tracer.trace_radiance(data, origin, direction, ctx)
    finally:
        _env("SHADE_FETCH", old)
    rgb_j, dist_j = tracer.trace_radiance(data, origin, direction, ctx)
    assert np.asarray(dist_p > 0).sum() > 100  # the probe actually hits
    np.testing.assert_array_equal(np.asarray(rgb_j), np.asarray(rgb_p))
    np.testing.assert_array_equal(np.asarray(dist_j), np.asarray(dist_p))


def test_attr_rows_refresh_on_transform_update():
    sc = scene_mod.cube_scene()
    data = sc.build()
    maps = dynamic.build_maps(sc)
    tf = np.asarray(data.instances.transform).copy()
    tf[1, :3, 3] += np.asarray([0.5, 0.25, -0.1], np.float32)
    new = dynamic.update_transforms(data, maps, jnp.asarray(tf))
    # joined world positions track the new soup exactly
    np.testing.assert_array_equal(np.asarray(new.attr_rows[:, 0:3]),
                                  np.asarray(new.triangles.v0))
    np.testing.assert_array_equal(np.asarray(new.attr_rows[:, 15:18]),
                                  np.asarray(new.triangles.v1))
    # a full host-side rejoin agrees
    rebuilt = schema.build_attr_rows(new.vertices, new.instances,
                                     new.triangles, new.materials)
    np.testing.assert_array_equal(np.asarray(new.attr_rows),
                                  np.asarray(rebuilt))
    # and the moved instance actually moved
    assert np.abs(np.asarray(new.attr_rows) -
                  np.asarray(data.attr_rows)).max() > 0.2
