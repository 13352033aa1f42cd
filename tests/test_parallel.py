"""Multi-device sharded rendering on the 8-device CPU mesh."""
import jax
import numpy as np
import pytest

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.parallel.mesh import make_mesh, row_sharding
from hybridrenderer.parallel.sharded import ShardedRenderer
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

FLAGS = RenderFlags.LIGHT | RenderFlags.IBL


def test_mesh_and_sharding():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    sh = row_sharding(mesh)
    x = jax.device_put(np.zeros((64, 32), np.float32), sh)
    assert len(x.addressable_shards) == 8


def test_sharded_matches_single_device():
    """Row-sharded frame == single-device frame (forward path)."""
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=FLAGS, raster_backend="jnp")
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    single = Renderer(s, data)
    ref = single.render_np(cam.step())

    mesh = make_mesh(8)
    cam2 = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                       yaw=0.6, focal_point=(0, 0.7, 0))
    sharded = ShardedRenderer(s, data, mesh)
    out = np.asarray(sharded.render(cam2.step()))
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_sharded_history_carries():
    """Second frame consumes sharded carried state without error."""
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=FLAGS | RenderFlags.TAA, raster_backend="jnp")
    mesh = make_mesh(8)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    r = ShardedRenderer(s, data, mesh)
    a = np.asarray(r.render(cam.step(True)))
    b = np.asarray(r.render(cam.step(True)))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert a.shape == b.shape == (64, 64, 3)


def test_sharded_hybrid_matches_single_device():
    """Row-sharded HYBRID frame (raster + RT shadow/AO + SVGF +
    composition) == single-device frame, with ray passes pinned
    per-shard via shard_map."""
    data = scenes.cube_scene().build()
    flags = RenderFlags.default_hybrid()
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=flags, raster_backend="jnp",
                       trace_backend="jnp")
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    single = Renderer.for_scene(s, data)
    ref = single.render_np(cam.step())
    ref2 = single.render_np(cam.step())

    mesh = make_mesh(8)
    cam2 = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                       yaw=0.6, focal_point=(0, 0.7, 0))
    sharded = ShardedRenderer.for_scene(s, data, mesh)
    out = np.asarray(sharded.render(cam2.step()))
    np.testing.assert_allclose(out, ref, atol=2e-4)
    # frame 2: carried SVGF/history state stays sharded and equal
    out2 = np.asarray(sharded.render(cam2.step()))
    np.testing.assert_allclose(out2, ref2, atol=2e-4)


def test_sharded_hybrid_shard_map_rays_off_matches_on():
    """GSPMD-only (shard_rays=False) and shard_map ray paths agree —
    the wrapping changes placement, not pixels."""
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid(),
                       raster_backend="jnp", trace_backend="jnp")
    mesh = make_mesh(8)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    a = np.asarray(
        ShardedRenderer.for_scene(s, data, mesh).render(cam.step()))
    b = np.asarray(
        ShardedRenderer.for_scene(s, data, mesh,
                                  shard_rays=False).render(cam.step()))
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_sharded_full_graph_matches_single_device():
    """Row-sharded reflection+GI == single-device: the shard_map
    trace_radiance path must reproduce the global NEE seed stream
    (pix_offset) and the tile-major relayout per shard. (SVGF chains
    are left off — they shard via plain GSPMD and are covered by the
    hybrid equality test; including them triples the CPU-mesh compile
    time of this test.)"""
    data = scenes.cornell_scene().build()
    flags = (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
             | RenderFlags.REFLECTION | RenderFlags.GI)
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=flags, raster_backend="jnp",
                       trace_backend="jnp")
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.3)
    single = Renderer.for_scene(s, data)
    ref = single.render_np(cam.step())

    mesh = make_mesh(8)
    cam2 = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.3)
    sharded = ShardedRenderer.for_scene(s, data, mesh)
    out = np.asarray(sharded.render(cam2.step()))
    np.testing.assert_allclose(out, ref, atol=2e-4)
