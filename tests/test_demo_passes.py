"""RTAOPass / RayQueryPass — the reference's unused demo passes
(RTAOPass.cpp:11-31, RayQueryPass.cpp:18-50), run standalone against a
real G-buffer + tracer."""
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


def _setup(size=48):
    data = scene_mod.cube_scene().build()
    tracer = SceneTracer.build(data)
    cam = OrbitCamera(width=size, height=size, distance=6.0, pitch=0.5,
                      focal_point=(0, 0.75, 0))
    state = cam.step()
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, size, size, jitter_enabled=False)
    gb = gbuffer.build_gbuffer(vis, data, state)
    settings = RenderSettings(width=size, height=size,
                              path=RenderPathType.HYBRID,
                              flags=RenderFlags.LIGHT | RenderFlags.IBL)
    params = FrameParams(
        sun_direction=data.sun.direction, sun_color=data.sun.color,
        sun_intensity=data.sun.intensity, ambient_strength=data.sun.ambient,
        exposure=jnp.float32(1.0),
        svgf_phi=jnp.asarray([4.0, 128.0, 0.02, 0.0], jnp.float32),
        frame_index=jnp.uint32(1))

    def shadow_query(p, n, d, t, active=None, **kw):
        return tracer.shadow_query(data, p, n, d, t, active=active, **kw)

    ctx = FrameContext(scene=data, cam=state, params=params,
                       settings=settings, state=None, history_valid=False,
                       shadow_query=shadow_query, trace_radiance=None)
    return gb, ctx, settings


def test_rtao_pass():
    gb, ctx, settings = _setup()
    fn, reads, writes, _ = rt_passes.make_rtao_pass(settings)
    assert reads == ("_GBuffer",) and writes == (RS.AO_RAW,)
    out = fn({"_GBuffer": gb}, ctx)
    ao = np.asarray(out[RS.AO_RAW])
    assert ao.shape == (48, 48, 4)
    bg = np.asarray(gb.background)
    # background forced to 1.0 (rt_ao.rgen:17-20)
    np.testing.assert_array_equal(ao[bg, 0], 1.0)
    fg = ao[~bg, 0]
    assert ((fg >= 0.0) & (fg <= 1.0)).all()
    assert (fg < 0.5).any()      # floor next to the cube sees occlusion
    assert (fg > 0.5).any()      # open surfaces stay unoccluded


def test_rtao_pass_no_tracer_is_neutral():
    gb, ctx, settings = _setup()
    ctx.shadow_query = None
    fn, *_ = rt_passes.make_rtao_pass(settings)
    ao = np.asarray(fn({"_GBuffer": gb}, ctx)[RS.AO_RAW])
    np.testing.assert_array_equal(ao[..., 0], 1.0)


def test_skybox_pass():
    from hybridrenderer.graph import passes as g_passes

    gb, ctx, settings = _setup()
    fn, reads, writes, _ = g_passes.make_skybox_pass(settings)
    assert reads == () and writes == (RS.FINAL_COLOR,)
    out = fn({}, ctx)
    color = np.asarray(out[RS.FINAL_COLOR])
    assert color.shape == (48, 48, 3)
    assert np.isfinite(color).all()
    # procedural gradient: sky above (top rows) differs from ground fade
    assert abs(color[:8].mean() - color[-8:].mean()) > 1e-3
    # a fullscreen pass ignores geometry: all pixels written
    assert (color >= 0.0).all() and color.mean() > 0.01


def test_rayquery_pass():
    gb, ctx, settings = _setup()
    fn, reads, writes, _ = rt_passes.make_rayquery_pass(settings)
    assert reads == ("_GBuffer",) and writes == (RS.FINAL_COLOR,)
    out = fn({"_GBuffer": gb}, ctx)
    color = np.asarray(out[RS.FINAL_COLOR])
    assert color.shape == (48, 48, 3)
    assert np.isfinite(color).all()
    bg = np.asarray(gb.background)
    np.testing.assert_array_equal(color[bg], 0.0)
    lit = color[~bg]
    assert lit.max() > 0.05      # sun-lit surfaces are visibly shaded
    # the cube casts a ray-query shadow: some foreground pixels are
    # substantially darker than the brightest lit ones
    assert lit.max() > 3.0 * max(lit.min(), 1e-6) or lit.min() < 0.02
