"""End-to-end textured rendering: texture stack → sampled albedo."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import DisplayMode, RenderFlags, RenderPathType
from hybridrenderer.ops import texture as tex_ops
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import geometry
from hybridrenderer.scene.scene import Scene
from hybridrenderer.scene.schema import Material, TextureStack


def _checker_stack(n=8):
    img = np.indices((n, n)).sum(0) % 2
    data = np.zeros((1, n, n, 4), np.float32)
    data[0, ..., 0] = img          # red checker
    data[0, ..., 1] = 1.0 - img    # green inverse
    data[0, ..., 3] = 1.0
    return TextureStack(data=jnp.asarray(data),
                        sizes=jnp.asarray([[n, n]], np.int32))


def test_bilinear_sampler_checker():
    stack = _checker_stack(2)
    uv = jnp.asarray([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75]])
    tid = jnp.zeros((3,), jnp.int32)
    out = np.asarray(tex_ops.sample_nearest(stack.data, stack.sizes, tid, uv,
                                            jnp.zeros(4)))
    assert out[0, 0] == 0.0 and out[1, 0] == 1.0 and out[2, 0] == 1.0


def test_sampler_default_when_no_texture():
    stack = _checker_stack(2)
    tid = jnp.full((2,), -1, jnp.int32)
    uv = jnp.zeros((2, 2))
    out = np.asarray(tex_ops.sample_bilinear(
        stack.data, stack.sizes, tid, uv, jnp.asarray([9.0, 0, 0, 1])))
    np.testing.assert_allclose(out[:, 0], 9.0)


def test_textured_forward_render():
    """A checkerboard colour texture must show up in the rendered frame."""
    sc = Scene("tex")
    m = sc.add_material(Material(name="checker", colour=(1, 1, 1),
                                 roughness=0.8, colour_texture=0))
    plane = geometry.plane(size=10.0, material=m, uv_scale=2.0)
    sc.add_entity(sc.add_mesh(plane))
    sc.textures = _checker_stack(8)
    sc.set_sun((-0.3, -1.0, -0.2), intensity=3.0, ambient=0.3)
    data = sc.build()

    s = RenderSettings(width=96, height=96, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT, raster_backend="jnp",
                       display_mode=DisplayMode.ALBEDO)
    r = Renderer(s, data)
    cam = OrbitCamera(width=96, height=96, distance=8.0, pitch=1.1,
                      focal_point=(0, 0, 0))
    img = r.render_np(cam.step())
    # looking nearly straight down at the checker: both checker colors
    # present with significant variation
    center = img[20:76, 20:76]
    assert center[..., 0].std() > 0.08, "checker pattern missing (red)"
    assert center[..., 1].std() > 0.08, "checker pattern missing (green)"
    # red and green anti-correlated (inverse checkers)
    r_flat = center[..., 0].ravel()
    g_flat = center[..., 1].ravel()
    assert np.corrcoef(r_flat, g_flat)[0, 1] < -0.3


def _rand_stack(rng, n_tex=3, size=16):
    """Random stack with per-texture TRUE sizes below the padded size."""
    data = np.zeros((n_tex, size, size, 4), np.float32)
    sizes = np.zeros((n_tex, 2), np.int32)
    for i in range(n_tex):
        h = int(rng.integers(4, size + 1))
        w = int(rng.integers(4, size + 1))
        data[i, :h, :w] = rng.random((h, w, 4))
        sizes[i] = (h, w)
    return TextureStack(data=jnp.asarray(data),
                        sizes=jnp.asarray(sizes))


def test_quad_layout_matches_four_tap():
    """The one-gather quad path is bit-exact vs the 4-tap path, REPEAT
    wrap at each texture's true size included."""
    rng = np.random.default_rng(3)
    stack = _rand_stack(rng)
    quads = tex_ops.build_quads(stack.data, stack.sizes)
    # uv far outside [0,1) exercises wrap; include exact texel corners
    uv = jnp.asarray(rng.random((257, 2)) * 6.0 - 3.0, jnp.float32)
    tid = jnp.asarray(rng.integers(-1, 3, 257), jnp.int32)
    dflt = jnp.asarray([9.0, 8.0, 7.0, 1.0], jnp.float32)
    ref = np.asarray(tex_ops.sample_bilinear(
        stack.data, stack.sizes, tid, uv, dflt))
    out = np.asarray(tex_ops.sample_bilinear_quad(
        quads, stack.sizes, tid, uv, dflt))
    np.testing.assert_array_equal(out, ref)


def test_quad_gather_variants_identical(monkeypatch):
    """The flattened 1-D row-index gather (HR_TEX_GATHER=flat, the
    default — engages XLA's fast small-table row-gather path) is
    bit-exact vs the 3-D advanced index."""
    rng = np.random.default_rng(5)
    stack = _rand_stack(rng)
    quads = tex_ops.build_quads(stack.data, stack.sizes)
    uv = jnp.asarray(rng.random((257, 2)) * 6.0 - 3.0, jnp.float32)
    tid = jnp.asarray(rng.integers(-1, 3, 257), jnp.int32)
    dflt = jnp.asarray([9.0, 8.0, 7.0, 1.0], jnp.float32)
    outs = []
    for mode in ("flat", "3d"):
        monkeypatch.setenv("HR_TEX_GATHER", mode)
        outs.append(np.asarray(tex_ops.sample_bilinear_quad(
            quads, stack.sizes, tid, uv, dflt)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_sample_stack_dispatch():
    """sample_stack picks the quad path when quads are present and the
    4-tap path otherwise — identical results either way."""
    rng = np.random.default_rng(5)
    stack = _rand_stack(rng)
    uv = jnp.asarray(rng.random((64, 2)), jnp.float32)
    tid = jnp.asarray(rng.integers(0, 3, 64), jnp.int32)
    dflt = jnp.zeros((4,), jnp.float32)
    base = np.asarray(tex_ops.sample_stack(stack, tid, uv, dflt))
    import dataclasses as dc
    with_quads = dc.replace(
        stack, quads=tex_ops.build_quads(stack.data, stack.sizes))
    np.testing.assert_array_equal(
        np.asarray(tex_ops.sample_stack(with_quads, tid, uv, dflt)), base)


def test_scene_build_finalizes_textures():
    """Scene.build derives static slot_usage from materials and bakes
    quads; only the colour slot is used by the stress scene."""
    from hybridrenderer.scene.scene import stress_scene
    data = stress_scene(num_objects=4, textured=True).build()
    assert data.textures.slot_usage == (True, False, False, False)
    assert data.textures.quads is not None
    assert data.textures.quads.shape == data.textures.data.shape[:3] + (16,)
    plain = stress_scene(num_objects=4).build()
    assert plain.textures.slot_usage == (False, False, False, False)
    assert plain.textures.quads is None


def test_quad_bake_budget_gate(monkeypatch):
    """Above the HBM quad budget the bake is skipped (4-tap fallback) —
    the high-res-texture memory trade."""
    import numpy as np

    from hybridrenderer.scene import scene as scenes

    monkeypatch.setenv("HR_QUAD_MAX_MB", "0")
    data = scenes.stress_scene(num_objects=4, textured=True).build()
    assert data.textures.quads is None
    monkeypatch.delenv("HR_QUAD_MAX_MB")
    data2 = scenes.stress_scene(num_objects=4, textured=True).build()
    assert data2.textures.quads is not None
    # both paths must render the same image (sample_bilinear fallback)
    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.runtime.renderer import Renderer

    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT)
    cam = OrbitCamera(width=64, height=64, distance=18.0, pitch=0.5,
                      yaw=0.8, focal_point=(0, 2.0, 0))
    st = cam.step()
    a = np.asarray(Renderer.for_scene(s, data).render_np(st))
    b = np.asarray(Renderer.for_scene(s, data2).render_np(st))
    assert np.abs(a - b).max() < 1e-5


def test_u8_storage_matches_f32_for_u8_sources():
    """HR_TEX_BITS=8 (u8 data + quad stacks, reference RGBA8 parity):
    bit-exact vs f32 storage when sources are u8-quantized, and the
    quad path stays bit-exact vs the 4-tap path under u8 storage."""
    rng = np.random.default_rng(11)
    stack = _rand_stack(rng)
    # u8-quantized source: u8 round trip is exact
    data = jnp.round(stack.data * 255.0) / 255.0
    data8 = tex_ops.quantize_u8(data)
    assert data8.dtype == jnp.uint8
    quads = tex_ops.build_quads(data, stack.sizes)
    quads8 = tex_ops.build_quads(data8, stack.sizes)
    assert quads8.dtype == jnp.uint8
    uv = jnp.asarray(rng.random((257, 2)) * 6.0 - 3.0, jnp.float32)
    tid = jnp.asarray(rng.integers(-1, 3, 257), jnp.int32)
    dflt = jnp.asarray([9.0, 8.0, 7.0, 1.0], jnp.float32)
    ref4 = np.asarray(tex_ops.sample_bilinear(
        data, stack.sizes, tid, uv, dflt))
    out4 = np.asarray(tex_ops.sample_bilinear(
        data8, stack.sizes, tid, uv, dflt))
    np.testing.assert_allclose(out4, ref4, atol=1e-6)
    refq = np.asarray(tex_ops.sample_bilinear_quad(
        quads, stack.sizes, tid, uv, dflt))
    outq = np.asarray(tex_ops.sample_bilinear_quad(
        quads8, stack.sizes, tid, uv, dflt))
    np.testing.assert_allclose(outq, refq, atol=1e-6)
    np.testing.assert_array_equal(outq, out4)


def test_finalized_u8_storage(monkeypatch):
    """TextureStack.finalized under HR_TEX_BITS=8 stores u8 data and
    quads; a textured frame stays within u8 quantization error of the
    f32-storage frame."""
    monkeypatch.setenv("HR_TEX_BITS", "8")
    from hybridrenderer.scene.scene import stress_scene

    data = stress_scene(num_objects=4, textured=True, tex_size=16).build()
    assert data.textures.data.dtype == jnp.uint8
    assert data.textures.quads.dtype == jnp.uint8
    monkeypatch.delenv("HR_TEX_BITS")
    data32 = stress_scene(num_objects=4, textured=True, tex_size=16).build()
    st = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                        flags=RenderFlags.LIGHT)
    cam = OrbitCamera(width=64, height=64, distance=25.0).step()
    a = Renderer.for_scene(st, data).render_np(cam)
    b = Renderer.for_scene(st, data32).render_np(cam)
    # u8 storage error ≤ 1/510 per channel pre-shading; allow shading gain
    assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() <= 3


def test_quad_gather_modes_agree(monkeypatch):
    """HR_TEX_GATHER u16/barrier are bit-exact vs flat; bf16 within
    0.5/255 (below the u8 source quantization step)."""
    import os

    rng = np.random.default_rng(3)
    N, TH, TW = 2, 16, 16
    data = jnp.asarray(rng.random((N, TH, TW, 4), np.float32))
    sizes = jnp.asarray(np.full((N, 2), 16, np.int32))
    quads = tex_ops.build_quads(data, sizes)
    tex_id = jnp.asarray(rng.integers(-1, N, (64,)).astype(np.int32))
    uv = jnp.asarray((rng.random((64, 2)) * 2 - 0.5).astype(np.float32))
    default = jnp.ones((4,), jnp.float32)

    outs = {}
    for m in ["flat", "u16", "bf16", "barrier"]:
        monkeypatch.setenv("HR_TEX_GATHER", m)
        outs[m] = np.asarray(tex_ops.sample_bilinear_quad(
            quads, sizes, tex_id, uv, default))
    for m in ["u16", "barrier"]:
        np.testing.assert_array_equal(outs["flat"], outs[m])
    assert np.abs(outs["bf16"] - outs["flat"]).max() < 0.5 / 255.0 + 1e-3


def test_window_sampler_matches_bilinear(monkeypatch):
    """HR_TEX_SAMPLER=window (group-window atlas path, r5): matches
    sample_bilinear on a coherent uv field incl. a REPEAT-seam crossing
    (the weight contractions run at full f32 precision)."""
    rng = np.random.default_rng(9)
    N, T = 3, 64
    data = jnp.asarray(rng.random((N, T, T, 4), np.float32))
    sizes = jnp.asarray(np.full((N, 2), T, np.int32))
    atlas = tex_ops.build_window_atlas(data, sizes)

    import dataclasses as dc

    from hybridrenderer.scene.schema import TextureStack
    stack = TextureStack(data=data, sizes=sizes, windows=atlas)

    H, W = 64, 128
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # group texel span <= 3 per axis (the window-span condition:
    # texels-per-pixel ~<= 1 including cross-derivatives)
    uv = np.stack([xx / W * 1.5 + 0.03 * np.sin(yy / 17),
                   yy / H * 0.8 + 0.03 * np.cos(xx / 23)], axis=-1)
    uv = jnp.asarray(uv.astype(np.float32))
    tex_id = jnp.asarray(((xx.astype(np.int32) // 32) % N))
    tex_id = tex_id.at[0, 0].set(-1)   # default path still works
    default = jnp.ones((4,), jnp.float32)

    ref = tex_ops.sample_bilinear(data, sizes, tex_id, uv, default)
    got = tex_ops.sample_stack(stack, tex_id, uv, default)
    err = np.abs(np.asarray(ref) - np.asarray(got))
    assert err.max() < 1e-5, err.max()
    # flat-shaped queries fall back to the non-window path
    flat = tex_ops.sample_stack(stack, tex_id.reshape(-1),
                                uv.reshape(-1, 2), default)
    np.testing.assert_allclose(np.asarray(flat).reshape(H, W, 4),
                               np.asarray(ref), atol=1e-5)
