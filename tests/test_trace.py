"""Ray-tracing core: LBVH build validity + traversal vs brute force."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.ops import bvh as bvh_mod
from hybridrenderer.ops import trace
from hybridrenderer.scene import scene as scene_mod


def _soup(data):
    s = data.triangles
    return s.v0, s.v1, s.v2


def test_bvh_valid_cube_scene():
    data = scene_mod.cube_scene().build()
    v0, v1, v2 = _soup(data)
    b = bvh_mod.build_bvh(v0, v1, v2)
    assert int(b.num_tris) == 14
    assert bvh_mod.validate_bvh(b, v0, v1, v2)


def test_bvh_valid_cornell():
    data = scene_mod.cornell_scene().build()
    v0, v1, v2 = _soup(data)
    b = bvh_mod.build_bvh(v0, v1, v2)
    assert bvh_mod.validate_bvh(b, v0, v1, v2)


def test_bvh_duplicate_centroids():
    """Degenerate Morton input (identical centroids) must still build a
    valid tree via index tie-breaking."""
    t = jnp.zeros((16, 3), jnp.float32)
    v0 = t
    v1 = t + jnp.array([1.0, 0.0, 0.0])
    v2 = t + jnp.array([0.0, 1.0, 0.0])
    b = bvh_mod.build_bvh(v0, v1, v2)
    assert bvh_mod.validate_bvh(b, v0, v1, v2)


def _random_rays(n, seed, origin_box=3.0, target_box=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-origin_box, origin_box, (n, 3)).astype(np.float32)
    o[:, 1] += 3.0
    target = rng.uniform(-target_box, target_box, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_traversal_matches_brute_force():
    data = scene_mod.cube_scene().build()
    v0, v1, v2 = _soup(data)
    b = bvh_mod.build_bvh(v0, v1, v2)
    o, d = _random_rays(256, 42)
    tb, trib, _, _ = trace.intersect_brute(v0, v1, v2, o, d, 1e-3, 1e10)
    tv, triv, _, _ = trace.intersect_bvh(b, v0, v1, v2, o, d, 1e-3, 1e10)
    np.testing.assert_allclose(np.asarray(tv), np.asarray(tb),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(triv), np.asarray(trib))


def test_traversal_matches_brute_force_cornell():
    data = scene_mod.cornell_scene().build()
    v0, v1, v2 = _soup(data)
    b = bvh_mod.build_bvh(v0, v1, v2)
    o, d = _random_rays(128, 7)
    tb, trib, _, _ = trace.intersect_brute(v0, v1, v2, o, d, 1e-3, 1e10)
    tv, triv, _, _ = trace.intersect_bvh(b, v0, v1, v2, o, d, 1e-3, 1e10)
    hit_b = np.asarray(trib) >= 0
    hit_v = np.asarray(triv) >= 0
    np.testing.assert_array_equal(hit_v, hit_b)
    # distances must agree even if coplanar tri ids differ
    np.testing.assert_allclose(np.asarray(tv)[hit_b], np.asarray(tb)[hit_b],
                               rtol=1e-4, atol=1e-4)


def test_any_hit_occlusion():
    data = scene_mod.cube_scene().build()
    tracer = trace.SceneTracer.build(data)
    # ray from above the cube straight down: occluded before the floor
    o = jnp.array([[0.0, 5.0, 0.0], [5.0, 5.0, 5.0]])
    d = jnp.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    vis = tracer.occluded(data, o, d, 100.0)
    assert float(vis[0]) == 0.0  # hits cube/floor
    assert float(vis[1]) == 0.0  # hits floor
    vis_up = tracer.occluded(data, o, -d, 100.0)
    np.testing.assert_array_equal(np.asarray(vis_up), [1.0, 1.0])


def test_shadow_query_shape_and_semantics():
    data = scene_mod.cube_scene().build()
    tracer = trace.SceneTracer.build(data)
    # two "pixels": one next to the cube (lit), one under-ish shadowed dir
    pos = jnp.array([[[3.0, 0.01, 0.0], [0.0, 0.01, 0.0]]])  # (1,2,3)
    nrm = jnp.array([[[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]]])
    # direction through the cube for the second point
    d1 = jnp.array([0.0, 1.0, 0.0])
    d2 = jnp.array([0.0, 1.0, 0.0])
    dirs = jnp.stack([jnp.stack([d1, d2])])
    vis = tracer.shadow_query(data, pos, nrm, dirs, 1e10)
    assert vis.shape == (1, 2)
    assert float(vis[0, 0]) == 1.0  # open sky
    assert float(vis[0, 1]) == 0.0  # blocked by the cube above


def test_native_builder_matches_jnp():
    """native/bvh_builder.cpp produces the IDENTICAL tree (topology,
    sorted order, AABBs) to the jitted jnp builder."""
    from hybridrenderer.scene import scene as scenes

    s = scenes.cornell_scene().build().triangles
    ref = bvh_mod.build_bvh(s.v0, s.v1, s.v2)
    nat = bvh_mod.build_bvh_native(s.v0, s.v1, s.v2)
    if nat is None:
        import pytest

        pytest.skip("native builder unavailable")
    np.testing.assert_array_equal(np.asarray(nat.tri), np.asarray(ref.tri))
    np.testing.assert_array_equal(np.asarray(nat.left), np.asarray(ref.left))
    np.testing.assert_array_equal(np.asarray(nat.right),
                                  np.asarray(ref.right))
    np.testing.assert_allclose(np.asarray(nat.node_min),
                               np.asarray(ref.node_min), atol=0)
    np.testing.assert_allclose(np.asarray(nat.node_max),
                               np.asarray(ref.node_max), atol=0)


def test_fused_shadow_ao_pass_matches_split(monkeypatch):
    """RT_FUSE_SHADOW_AO=1 (one any-hit dispatch for sun/light shadow +
    AO with per-ray tMax) renders bit-identically to the split
    dispatches — any-hit visibility is packet-layout-independent."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene import scene as scenes

    data = scenes.cornell_scene().build()
    flags = (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
             | RenderFlags.SHADOW | RenderFlags.AO | RenderFlags.SVGF
             | RenderFlags.SVGF_SPATIAL)
    st = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                        flags=flags)
    cam = OrbitCamera(width=64, height=64, distance=6.0, pitch=0.4,
                      focal_point=(0, 1, 0)).step()
    img0 = np.asarray(Renderer.for_scene(st, data).render(cam))
    monkeypatch.setenv("RT_FUSE_SHADOW_AO", "1")
    img1 = np.asarray(Renderer.for_scene(st, data).render(cam))
    np.testing.assert_array_equal(img0, img1)
