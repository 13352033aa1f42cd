"""Math substrate tests — projections, view matrices, frusta, Halton."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.core import maths
from hybridrenderer.core.camera import CameraState, OrbitCamera


def test_reversed_z_projection_near_far():
    """Near plane → NDC z=1, far plane → z=0 (EditorCamera.cpp:20-39)."""
    n, f = 0.1, 1000.0
    P = maths.perspective_reversed_z(45.0, 1.0, n, f)
    for zv, expect in [(-n, 1.0), (-f, 0.0)]:
        clip = P @ jnp.array([0.0, 0.0, zv, 1.0])
        ndc_z = clip[2] / clip[3]
        assert abs(float(ndc_z) - expect) < 1e-4
        assert float(clip[3]) > 0  # w = -z_view positive in front


def test_projection_y_flip():
    """Vulkan clip-space Y points down: +Y view → negative NDC y."""
    P = maths.perspective_reversed_z(60.0, 16 / 9, 0.1, 100.0)
    clip = P @ jnp.array([0.0, 1.0, -5.0, 1.0])
    assert float(clip[1] / clip[3]) < 0


def test_look_at_inverse_roundtrip():
    eye = jnp.array([3.0, 4.0, 5.0])
    V = maths.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    # camera position recovered from inverse view
    Vi = maths.inverse(V)
    np.testing.assert_allclose(np.asarray(Vi[:3, 3]), np.asarray(eye), atol=1e-5)
    # center maps to -z axis
    c = maths.transform_point(V, jnp.zeros(3))
    assert float(c[2]) < 0 and abs(float(c[0])) < 1e-5 and abs(float(c[1])) < 1e-5


def test_halton_sequence_values():
    # Halton base 2: 1/2, 1/4, 3/4, 1/8 ...
    assert maths.halton(1, 2) == 0.5
    assert maths.halton(2, 2) == 0.25
    assert maths.halton(3, 2) == 0.75
    assert abs(maths.halton(1, 3) - 1 / 3) < 1e-7


def test_jitter_table_scale():
    t = np.asarray(maths.halton_jitter_sequence(512, 256))
    assert t.shape == (16, 2)
    # |jitter| <= 0.5 px in NDC units: 0.5 * 2/W
    assert np.all(np.abs(t[:, 0]) <= 1.0 / 512 + 1e-7)
    assert np.all(np.abs(t[:, 1]) <= 1.0 / 256 + 1e-7)
    assert not np.allclose(t[0], t[1])


def test_frustum_culling_conservative():
    cam = OrbitCamera(width=128, height=128, distance=10.0)
    planes = cam.frustum_planes()
    # box at origin (camera looks at origin) must be visible
    lo = jnp.array([[-1.0, -1.0, -1.0]])
    hi = jnp.array([[1.0, 1.0, 1.0]])
    assert not bool(maths.aabb_outside_frustum(lo, hi, planes)[0])
    # box far behind the camera must be culled
    lo2 = lo + jnp.array([0.0, 0.0, 100.0])
    hi2 = hi + jnp.array([0.0, 0.0, 100.0])
    assert bool(maths.aabb_outside_frustum(lo2, hi2, planes)[0])


def test_camera_state_jitter_rolls():
    cam = OrbitCamera(width=64, height=64)
    s0 = cam.step(taa_enabled=True)
    s1 = cam.step(taa_enabled=True)
    assert not np.allclose(np.asarray(s0.jitter), np.asarray(s1.jitter))
    np.testing.assert_allclose(np.asarray(s1.prev_jitter), np.asarray(s0.jitter))
    np.testing.assert_allclose(np.asarray(s1.prev_view), np.asarray(s0.view))


def test_camera_state_inverses():
    cam = OrbitCamera(width=64, height=64, distance=3.0, pitch=0.4, yaw=1.0)
    s = cam.step()
    vp = s.proj @ s.view
    np.testing.assert_allclose(
        np.asarray(s.view_proj_inverse @ vp), np.eye(4), atol=5e-3
    )
    np.testing.assert_allclose(np.asarray(s.position), np.asarray(cam.position),
                               atol=1e-5)


def test_aabb_transform_contains_all_corners():
    lo = jnp.array([-1.0, -2.0, -3.0])
    hi = jnp.array([1.0, 0.5, 2.0])
    m = maths.translate([1.0, 2.0, 3.0]) @ maths.rotate_y(jnp.float32(0.7))
    nlo, nhi = maths.aabb_transform(lo, hi, m)
    corners = np.array(np.meshgrid(*zip(np.asarray(lo), np.asarray(hi)))).T.reshape(-1, 3)
    wc = corners @ np.asarray(m[:3, :3]).T + np.asarray(m[:3, 3])
    assert np.all(wc >= np.asarray(nlo) - 1e-5)
    assert np.all(wc <= np.asarray(nhi) + 1e-5)
