"""Depth-aware upsample (ops/image.upsample2x_depth_aware) unit tests +
the half-res reflection/GI e2e render that uses it.

The reference traces AO full-res (rt_shadow.rgen), and so does this
renderer; reflection/gi_half_res are the supported half-res ray-effect
tradeoffs.
"""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.ops import image as img_ops
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes


def test_upsample_constant_passthrough():
    z = jnp.full((16, 16), 5.0)
    v = jnp.full((8, 8), 0.37)
    out = np.asarray(img_ops.upsample2x_depth_aware(v, z[::2, ::2], z))
    np.testing.assert_allclose(out, 0.37, atol=1e-6)


def test_upsample_smooth_signal_close_to_bilinear():
    h = w = 32
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    full = (np.sin(ys / 7.0) * np.cos(xs / 9.0)).astype(np.float32)
    z = jnp.full((h, w), 3.0)
    out = np.asarray(img_ops.upsample2x_depth_aware(
        jnp.asarray(full[::2, ::2]), z[::2, ::2], z))
    # flat depth → pure tent reconstruction of the subsampled signal
    assert np.abs(out - full).max() < 0.08


def test_upsample_no_bleed_across_depth_edge():
    h = w = 16
    z_np = np.full((h, w), 2.0, np.float32)
    z_np[:, 8:] = 40.0                       # hard depth edge at x=8
    v_half = np.ones((8, 8), np.float32)
    v_half[:, 4:] = 0.0                      # signal follows the edge
    z = jnp.asarray(z_np)
    out = np.asarray(img_ops.upsample2x_depth_aware(
        jnp.asarray(v_half), z[::2, ::2], z))
    # near-side pixels must keep the near-side value: the far-side taps
    # are depth-rejected even where bilinear weights would pull them in
    assert out[:, :8].min() > 0.95
    assert out[:, 8:].max() < 0.05


def test_half_res_refl_gi_render_matches_full_res_roughly():
    data = scenes.cornell_scene().build()
    flags = (RenderFlags.LIGHT | RenderFlags.SHADOW
             | RenderFlags.REFLECTION | RenderFlags.GI)
    kw = dict(width=64, height=64, path=RenderPathType.HYBRID, flags=flags)
    cam = OrbitCamera(width=64, height=64, distance=6.0, pitch=0.3,
                      yaw=0.4, focal_point=(0, 1.0, 0))
    full = Renderer.for_scene(RenderSettings(**kw), data).render_np(cam.step())
    half = Renderer.for_scene(
        RenderSettings(reflection_half_res=True, gi_half_res=True, **kw),
        data).render_np(cam.step())
    assert np.isfinite(half).all()
    # same scene, same lighting: reconstruction stays close on average
    assert np.abs(half - full).mean() < 0.05


def test_reflection_half_res_quality_gate():
    """reflection_half_res is a supported speed/quality option: the
    depth-aware upsampled mirror signal must stay within
    a tight bound of the full-res render (CPU-measured 2026-08: mean
    0.38 / p99 1.0 / max 202 at isolated silhouette pixels on cornell,
    4 frames). Catches upsample regressions; GI half-res is gated
    separately (its interleaved-direction blocks interact with
    resolution)."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.runtime.output import to_u8
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene import scene as scenes

    flags = RenderFlags.default_hybrid() | RenderFlags.REFLECTION
    data = scenes.cornell_scene().build()

    def run(**kw):
        s = RenderSettings(width=128, height=128,
                           path=RenderPathType.HYBRID, flags=flags,
                           ao_block=8, **kw)
        r = Renderer.for_scene(s, data)
        cam = OrbitCamera(width=128, height=128, distance=13.0,
                          pitch=0.0, yaw=0.0, focal_point=(0, 2.5, 0))
        img = None
        for _ in range(4):
            img = r.render_np(cam.step(taa_enabled=True))
        return to_u8(img).astype(int)

    d = np.abs(run() - run(reflection_half_res=True))
    assert d.mean() <= 1.0, f"mean {d.mean()}"
    assert np.percentile(d, 99) <= 4, f"p99 {np.percentile(d, 99)}"


def test_gi_half_res_quality_gate():
    """gi_half_res REGRESSION gate — the knob is documented
    EXPERIMENTAL (core/config.py): converged p99 ~32 u8 is preview
    quality, and this bound only catches the upsample path rotting
    further, not banding. The
    interleave
    block is auto-halved at half-res so each direction block covers the
    SAME full-res screen area (rt_passes.make_rt_gi_pass) — without the
    halving the converged image drifted wholesale (CPU probe r4: mean
    err 21.7 u8). Converged (12-frame SVGF) half-res GI must stay near
    the full-res render; the bound is loose because GI is a denoised
    stochastic signal (CPU-measured 2026-08: mean 2.6 / p99 ~32)."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.runtime.output import to_u8
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene import scene as scenes

    flags = (RenderFlags.default_hybrid() | RenderFlags.GI
             | RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
             | RenderFlags.SVGF_SPATIAL)
    data = scenes.cornell_scene().build()

    def run(**kw):
        s = RenderSettings(width=128, height=128,
                           path=RenderPathType.HYBRID, flags=flags,
                           ao_block=8, gi_block=8, **kw)
        r = Renderer.for_scene(s, data)
        cam = OrbitCamera(width=128, height=128, distance=13.0,
                          pitch=0.0, yaw=0.0, focal_point=(0, 2.5, 0))
        img = None
        for _ in range(12):
            img = r.render_np(cam.step(taa_enabled=True))
        return to_u8(img).astype(int)

    d = np.abs(run() - run(gi_half_res=True))
    assert d.mean() <= 6.0, f"mean {d.mean()}"
    assert np.percentile(d, 99) <= 48, f"p99 {np.percentile(d, 99)}"
