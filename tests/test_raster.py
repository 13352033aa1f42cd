"""Rasterizer correctness: coverage, depth resolve, clipping, G-buffer."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core import maths
from hybridrenderer.core.camera import CameraState, OrbitCamera
from hybridrenderer.ops import gbuffer, raster
from hybridrenderer.scene import scene as scene_mod


def _identity_cam():
    # orthographic-ish camera straight at the z=-5 plane
    view = maths.look_at(jnp.array([0.0, 0.0, 5.0]), jnp.zeros(3),
                         jnp.array([0.0, 1.0, 0.0]))
    proj = maths.perspective_reversed_z(60.0, 1.0, 0.1, 100.0)
    return CameraState.create(view, proj)


def test_single_triangle_coverage():
    cam = _identity_cam()
    # big triangle around origin, facing camera
    verts = jnp.array([[-2.0, -2.0, 0.0], [2.0, -2.0, 0.0], [0.0, 2.5, 0.0]])
    vis = raster.rasterize_scene(
        verts, jnp.array([0]), jnp.array([1]), jnp.array([2]),
        cam, 64, 64, jitter_enabled=False)
    tri = np.asarray(vis.tri_id)
    # center covered, corners not
    assert tri[32, 32] == 0
    assert tri[0, 0] == -1 and tri[0, 63] == -1
    d = np.asarray(vis.depth)
    assert d[32, 32] > 0.0
    b1, b2 = np.asarray(vis.bary1), np.asarray(vis.bary2)
    cov = tri == 0
    assert np.all(b1[cov] >= -1e-4) and np.all(b2[cov] >= -1e-4)
    assert np.all(b1[cov] + b2[cov] <= 1.0 + 1e-4)


def test_depth_test_reversed_z():
    cam = _identity_cam()
    # tri 0 at z=0 (far-ish), tri 1 at z=2 (nearer to camera at z=5)
    verts = jnp.array([
        [-2.0, -2.0, 0.0], [2.0, -2.0, 0.0], [0.0, 2.5, 0.0],
        [-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.5, 2.0],
    ])
    vis = raster.rasterize_scene(
        verts, jnp.array([0, 3]), jnp.array([1, 4]), jnp.array([2, 5]),
        cam, 64, 64, jitter_enabled=False)
    tri = np.asarray(vis.tri_id)
    assert tri[32, 32] == 1  # nearer triangle wins
    # some periphery still shows triangle 0
    assert (tri == 0).sum() > 0


def test_winding_insensitive():
    cam = _identity_cam()
    verts = jnp.array([[-2.0, -2.0, 0.0], [2.0, -2.0, 0.0], [0.0, 2.5, 0.0]])
    a = raster.rasterize_scene(verts, jnp.array([0]), jnp.array([1]),
                               jnp.array([2]), cam, 32, 32, False)
    b = raster.rasterize_scene(verts, jnp.array([0]), jnp.array([2]),
                               jnp.array([1]), cam, 32, 32, False)
    ta, tb = np.asarray(a.tri_id), np.asarray(b.tri_id)
    # edge-exact pixels may flip with winding (no shared tie rule yet);
    # interiors must agree
    assert (ta != tb).mean() < 0.01
    same = ta == tb
    np.testing.assert_allclose(np.asarray(a.depth)[same],
                               np.asarray(b.depth)[same], atol=1e-6)


def test_near_plane_clipping_no_nans():
    cam = _identity_cam()
    # triangle spanning the camera plane (one vert far behind)
    verts = jnp.array([[-2.0, -2.0, 0.0], [2.0, -2.0, 0.0], [0.0, 0.5, 20.0]])
    vis = raster.rasterize_scene(
        verts, jnp.array([0]), jnp.array([1]), jnp.array([2]), cam, 64, 64, False)
    assert np.isfinite(np.asarray(vis.depth)).all()
    assert (np.asarray(vis.tri_id) == 0).sum() > 10  # front part still drawn


def test_cube_scene_gbuffer():
    sc = scene_mod.cube_scene()
    data = sc.build()
    cam = OrbitCamera(width=96, height=96, distance=6.0, pitch=0.5,
                      focal_point=(0, 0.75, 0))
    state = cam.step()
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, 96, 96, jitter_enabled=False)
    gb = gbuffer.build_gbuffer(vis, data, state)
    oid = np.asarray(gb.object_id)
    assert oid[48, 48] == 1  # cube instance at center
    assert (oid == 0).sum() > 100  # floor visible
    nrm = np.asarray(gb.normal)
    lens = np.linalg.norm(nrm[oid >= 0], axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)
    # static scene, static camera after first step → zero motion
    assert np.abs(np.asarray(gb.motion)[oid >= 0]).max() < 1e-4
    # cube albedo = red material
    np.testing.assert_allclose(np.asarray(gb.albedo)[48, 48],
                               [0.8, 0.15, 0.1], atol=1e-5)


def test_world_pos_matches_depth_reconstruction():
    """Interpolated world pos ≈ GetWorldPos(depth, uv) (common.glsl:102-107)."""
    sc = scene_mod.cube_scene()
    data = sc.build()
    cam = OrbitCamera(width=64, height=64, distance=6.0, pitch=0.5,
                      focal_point=(0, 0.75, 0))
    state = cam.step()
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, 64, 64, jitter_enabled=False)
    gb = gbuffer.build_gbuffer(vis, data, state)

    ys, xs = np.mgrid[0:64, 0:64]
    uv = np.stack([(xs + 0.5) / 64, (ys + 0.5) / 64], -1).astype(np.float32)
    ndc = np.concatenate([uv * 2 - 1, np.asarray(vis.depth)[..., None],
                          np.ones_like(uv[..., :1])], -1)
    m = np.asarray(state.view_proj_inverse)
    world_h = ndc @ m.T
    recon = world_h[..., :3] / world_h[..., 3:4]
    mask = np.asarray(gb.object_id) >= 0
    err = np.abs(recon[mask] - np.asarray(gb.world_pos)[mask])
    assert np.percentile(err, 95) < 5e-2  # f32 viewProjInverse precision


def test_backface_cull_single_sided():
    """Back-face culling (clip_triangles single_sided): an open quad seen
    from behind vanishes when single-sided, stays when double-sided; a
    closed mesh renders identically culled or not (the forward pipeline's
    VK_CULL_MODE_BACK_BIT, ForwardPass.cpp:45)."""
    cam = _identity_cam()  # camera at +z looking toward -z
    # triangle wound CCW as seen from +z (front toward camera)
    verts = jnp.array([[-2.0, -2.0, 0.0], [2.0, -2.0, 0.0], [0.0, 2.5, 0.0]])
    i0, i1, i2 = jnp.array([0]), jnp.array([1]), jnp.array([2])
    front = raster.rasterize_scene(verts, i0, i1, i2, cam, 64, 64,
                                   jitter_enabled=False,
                                   single_sided=jnp.array([True]))
    assert np.asarray(front.tri_id)[32, 32] == 0  # front face survives
    # same triangle with flipped winding = back face toward camera
    back = raster.rasterize_scene(verts, i1, i0, i2, cam, 64, 64,
                                  jitter_enabled=False,
                                  single_sided=jnp.array([True]))
    assert np.asarray(back.tri_id).max() == -1  # culled everywhere
    back2 = raster.rasterize_scene(verts, i1, i0, i2, cam, 64, 64,
                                   jitter_enabled=False,
                                   single_sided=jnp.array([False]))
    assert np.asarray(back2.tri_id)[32, 32] == 0  # double-sided survives


def test_backface_cull_closed_mesh_identical():
    """Culling a closed mesh (cube + sphere scene) never changes pixels."""
    data = scene_mod.cube_scene().build()
    cam = OrbitCamera(width=64, height=64, distance=6.0, pitch=0.5,
                      focal_point=(0, 0.75, 0))
    state = cam.step()
    kw = dict(jitter_enabled=False)
    a = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, 64, 64, **kw)
    b = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, state, 64, 64,
        single_sided=data.triangles.single_sided, **kw)
    assert np.array_equal(np.asarray(a.tri_id), np.asarray(b.tri_id))
    assert np.allclose(np.asarray(a.depth), np.asarray(b.depth))


def test_soup_corner_clip_matches_gather():
    """Gather-free clip (corner tables transformed directly) is
    bit-exact vs the shared-vertex gather path."""
    data = scene_mod.stress_scene(num_objects=6, seed=7).build()
    cam = OrbitCamera(width=128, height=64, distance=25.0, pitch=0.4, yaw=0.3,
                      focal_point=(0, 2, 0)).step()
    vp = jnp.asarray(cam.proj) @ jnp.asarray(cam.view)
    clip = raster.transform_to_clip(data.vertices.world_position, vp)
    ref = raster.clip_triangles(clip, data.triangles.i0, data.triangles.i1,
                                data.triangles.i2, 128, 64)
    corners = jnp.stack(
        [raster.transform_to_clip(data.triangles.v0, vp),
         raster.transform_to_clip(data.triangles.v1, vp),
         raster.transform_to_clip(data.triangles.v2, vp)], axis=1)
    out = raster.clip_triangles(None, None, None, None, 128, 64,
                                corners=corners)
    np.testing.assert_array_equal(np.asarray(out.valid),
                                  np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(out.sxy), np.asarray(ref.sxy))
    np.testing.assert_array_equal(np.asarray(out.z), np.asarray(ref.z))
    np.testing.assert_array_equal(np.asarray(out.tri_id),
                                  np.asarray(ref.tri_id))
