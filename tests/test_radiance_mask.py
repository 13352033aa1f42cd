"""Active-masked + tile-major trace_radiance (ops/trace.py) and the
half-res secondary-ray options (graph/rt_passes.py).

The reflection pass skips rays above the roughness cutoff and the GI
pass skips background pixels via ``active``; inactive rays must cost no
shading-NEE traversals AND still return a well-defined (sky) value.
(H, W) inputs take the tile-major relayout path — its result must be
identical to the flat path for active rays (NEE seeds are pinned to the
original pixel index for exactly this reason)."""
import jax.numpy as jnp
import numpy as np
import pytest

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.graph.params import FrameParams
from hybridrenderer.graph.passes import FrameContext
from hybridrenderer.ops import trace as trace_ops
from hybridrenderer.scene import scene as scene_mod


def _ctx(data, settings):
    params = FrameParams(
        sun_direction=data.sun.direction, sun_color=data.sun.color,
        sun_intensity=data.sun.intensity,
        ambient_strength=data.sun.ambient,
        exposure=jnp.float32(1.0),
        svgf_phi=jnp.asarray([4.0, 128.0, 0.02, 0.0], jnp.float32),
        frame_index=jnp.uint32(0))
    return FrameContext(scene=data, cam=None, params=params,
                        settings=settings, state=None, history_valid=False)


@pytest.fixture(scope="module")
def cornell():
    data = scene_mod.cornell_scene().build()
    settings = RenderSettings(width=32, height=32,
                              path=RenderPathType.HYBRID,
                              flags=RenderFlags.LIGHT | RenderFlags.IBL
                              | RenderFlags.EMISSIVE)
    tracer = trace_ops.SceneTracer.build(data, settings)
    return data, settings, tracer


def _rays(h, w):
    ys = np.linspace(-0.4, 0.4, h, dtype=np.float32)
    xs = np.linspace(-0.4, 0.4, w, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    o = np.stack([X * 4, Y * 4 + 3.0, np.full_like(X, 6.0)], axis=-1)
    d = np.stack([X * 0.2, Y * 0.2, -np.ones_like(X)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_image_mode_matches_flat(cornell):
    """(H, W) tile-major relayout path == flat path, bitwise-ish."""
    data, settings, tracer = cornell
    ctx = _ctx(data, settings)
    o, d = _rays(32, 32)
    rgb_img, dist_img = tracer.trace_radiance(data, o, d, ctx)
    rgb_flat, dist_flat = tracer.trace_radiance(
        data, o.reshape(-1, 3), d.reshape(-1, 3), ctx)
    np.testing.assert_allclose(np.asarray(rgb_img),
                               np.asarray(rgb_flat).reshape(32, 32, 3),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dist_img),
                               np.asarray(dist_flat).reshape(32, 32),
                               atol=1e-4)


def test_active_mask_gives_sky_and_preserves_rest(cornell):
    """Masked-off rays return the miss value; active rays are unchanged."""
    data, settings, tracer = cornell
    ctx = _ctx(data, settings)
    o, d = _rays(32, 32)
    act = jnp.asarray((np.arange(32)[:, None] + np.arange(32)[None, :])
                      % 2 == 0)
    rgb_all, dist_all = tracer.trace_radiance(data, o, d, ctx)
    rgb_m, dist_m = tracer.trace_radiance(data, o, d, ctx, active=act)
    a = np.asarray(act)
    np.testing.assert_allclose(np.asarray(rgb_m)[a],
                               np.asarray(rgb_all)[a], atol=1e-5)
    # inactive rays report miss distance
    assert (np.asarray(dist_m)[~a] == -1.0).all()


def test_half_res_secondary_renders():
    """reflection_half_res + gi_half_res render finite non-trivial output
    through the full graph (depth-aware upsample path)."""
    from hybridrenderer.runtime.renderer import Renderer

    data = scene_mod.cornell_scene().build()
    fl = (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
          | RenderFlags.REFLECTION | RenderFlags.GI)
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=fl, reflection_half_res=True,
                       gi_half_res=True)
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.3)
    img = np.asarray(r.render(cam.step()))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_lum_occlusion_gate_bias_bounded(cornell, monkeypatch):
    """SHADE_OCC_GATE=lum skips occlusion rays whose unshadowed
    contribution luminance is below OCC_LUM_EPS — the per-pixel bias is
    bounded by the threshold (skipped rays drop a ≤eps-luminance term)."""
    data, settings, tracer = cornell
    ctx = _ctx(data, settings)
    o, d = _rays(32, 32)
    rgb_ref, _ = tracer.trace_radiance(data, o, d, ctx)
    monkeypatch.setenv("SHADE_OCC_GATE", "lum")
    monkeypatch.setenv("OCC_LUM_EPS", "2e-3")
    rgb_gate, _ = tracer.trace_radiance(data, o, d, ctx)
    diff = np.abs(np.asarray(rgb_ref) - np.asarray(rgb_gate))
    # dropped terms have luminance <= eps; per-channel bound eps/0.0722
    assert diff.max() <= 2e-3 / 0.0722 + 1e-5
    assert diff.mean() < 5e-4
