"""Interleaved GI sampling + pattern-major radiance layout.

The layout is a pure relayout (results must match tile layout exactly);
the interleaved sampler changes the draw (one direction per 8x8-block
pattern), so the single-frame image differs from the per-pixel draw but
must stay finite and of the same magnitude — SVGF temporal accumulation
integrates the per-frame pattern rotations (same argument as AO).
"""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.graph import rt_passes
from hybridrenderer.graph.params import RS, FrameParams
from hybridrenderer.graph.passes import FrameContext
from hybridrenderer.ops import gbuffer, raster
from hybridrenderer.ops.trace import SceneTracer
from hybridrenderer.scene import scene as scene_mod

SIZE = 64


def _setup(gi_interleaved, gi_layout="tile"):
    data = scene_mod.cornell_scene().build()
    tracer = SceneTracer.build(data)
    cam = OrbitCamera(width=SIZE, height=SIZE, distance=13.0, pitch=0.0,
                      yaw=0.0, focal_point=(0, 2.5, 0))
    state = cam.step()
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, SIZE, SIZE, jitter_enabled=False)
    gb = gbuffer.build_gbuffer(vis, data, state)
    settings = RenderSettings(
        width=SIZE, height=SIZE, path=RenderPathType.HYBRID,
        flags=RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
        | RenderFlags.GI,
        gi_interleaved=gi_interleaved, gi_layout=gi_layout)
    params = FrameParams(
        sun_direction=data.sun.direction, sun_color=data.sun.color,
        sun_intensity=data.sun.intensity, ambient_strength=data.sun.ambient,
        exposure=jnp.float32(1.0),
        svgf_phi=jnp.asarray([4.0, 128.0, 0.02, 0.0], jnp.float32),
        frame_index=jnp.uint32(5))

    def trace_radiance(o, d, c, dep, active=None, **kw):
        return tracer.trace_radiance(data, o, d, c, dep, active=active,
                                     **kw)

    ctx = FrameContext(scene=data, cam=state, params=params,
                       settings=settings, state=None, history_valid=False,
                       shadow_query=None, trace_radiance=trace_radiance)
    return gb, ctx, settings, tracer, data


def test_pattern_layout_is_pure_relayout():
    gb, ctx, settings, tracer, data = _setup(True)
    n = np.asarray(gb.normal)
    d = jnp.asarray(np.where(np.linalg.norm(n, axis=-1, keepdims=True)
                             > 0.5, n, [0.0, 1.0, 0.0]))
    o = gb.world_pos
    rgb_t, dist_t = tracer.trace_radiance(data, o, d, ctx, 0,
                                          layout="tile")
    rgb_p, dist_p = tracer.trace_radiance(data, o, d, ctx, 0,
                                          layout="pattern")
    np.testing.assert_array_equal(np.asarray(rgb_p), np.asarray(rgb_t))
    np.testing.assert_array_equal(np.asarray(dist_p), np.asarray(dist_t))


def _gi_image(gi_interleaved, gi_layout="tile"):
    gb, ctx, settings, _, _ = _setup(gi_interleaved, gi_layout)
    fn, *_ = rt_passes.make_rt_gi_pass(settings)
    return np.asarray(fn({"_GBuffer": gb}, ctx)[RS.GI_RAW])


def test_interleaved_gi_sane_vs_per_pixel():
    gi_i = _gi_image(True)
    gi_p = _gi_image(False)
    for img in (gi_i, gi_p):
        assert np.isfinite(img).all()
        assert (img[..., :3] >= 0.0).all()
        assert img[..., :3].mean() > 1e-4   # cornell walls bounce light
    # same estimator in expectation; one frame differs but magnitudes
    # agree (the goldens pin the exact default output)
    ratio = gi_i[..., :3].mean() / max(gi_p[..., :3].mean(), 1e-9)
    assert 0.25 < ratio < 4.0, f"interleaved/per-pixel mean ratio {ratio}"


def test_pattern_layout_matches_tile_for_gi_pass():
    a = _gi_image(True, "tile")
    b = _gi_image(True, "pattern")
    np.testing.assert_array_equal(a, b)
