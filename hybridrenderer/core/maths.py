"""Linear-algebra substrate (GLM replacement).

The reference uses GLM column-major matrices (e.g. EditorCamera.cpp:20-54).
Here matrices are ordinary row-major ``(4, 4)`` float32 arrays applied as
``M @ v`` to column vectors; values match the reference's math exactly
(the GLM ``m[col][row]`` writes in EditorCamera.cpp:29-38 are transposed
into row-major below).

Everything is jnp-traceable; plain numpy arrays also work because only
`jax.numpy` ops are used.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 products on the geometry path ask for full precision: the GPU
# would otherwise run them in TF32 (about three decimal digits), which
# moves 1080p vertices by about a pixel
HIGHEST = jax.lax.Precision.HIGHEST


def mm(a, b):
    """Matrix product at full f32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def matvec(m, v):
    """Batched (..., i, j) @ (..., j) → (..., i) at full f32 precision."""
    return jnp.einsum("...ij,...j->...i", m, v, precision=HIGHEST)


def normalize(v, axis=-1, eps=1e-12):
    """Safe vector normalization."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return v / jnp.maximum(n, eps)


def dot(a, b, axis=-1, keepdims=False):
    return jnp.sum(a * b, axis=axis, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, axis=-1, keepdims=False):
    return jnp.linalg.norm(v, axis=axis, keepdims=keepdims)


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (incident pointing at surface)."""
    return i - 2.0 * dot(n, i, keepdims=True) * n


def mix(a, b, t):
    return a + (b - a) * t


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

def mat4_identity():
    return jnp.eye(4, dtype=jnp.float32)


def translate(t):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray(t, jnp.float32))


def scale(s):
    s = jnp.asarray(s, jnp.float32)
    s = jnp.broadcast_to(s, (3,))
    return jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))


def rotate_x(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], jnp.float32
    ) if not hasattr(angle, "shape") or angle.shape == () else _rot_dyn(c, s, 0)


def _rot_dyn(c, s, axis):
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    if axis == 0:
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    elif axis == 1:
        rows = [[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]]
    else:
        rows = [[c, -s, z, z], [s, c, z, z], [z, z, o, z], [z, z, z, o]]
    return jnp.stack([jnp.stack(r) for r in rows]).astype(jnp.float32)


def rotate_y(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return _rot_dyn(c, s, 1)


def rotate_z(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return _rot_dyn(c, s, 2)


def quat_from_pitch_yaw(pitch, yaw):
    """Quaternion for glm::quat(vec3(-pitch, -yaw, 0)) as EditorCamera.h uses.

    GLM builds the quaternion from Euler angles applied in X (pitch) then
    Y (yaw) then Z order.
    """
    hp, hy = -pitch * 0.5, -yaw * 0.5
    cp, sp = jnp.cos(hp), jnp.sin(hp)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    # q = qy(yaw about Y) * qx(pitch about X) composed per glm::quat(eulerXYZ)
    w = cp * cy
    x = sp * cy
    y = cp * sy
    z = -sp * sy
    return jnp.stack([w, x, y, z]).astype(jnp.float32)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q=(w,x,y,z)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    return (
        2.0 * dot(u, v, keepdims=True) * u
        + (w * w - dot(u, u, keepdims=True)) * v
        + 2.0 * w * cross(u, v)
    )


def quat_to_mat3(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        jnp.float32,
    )


def perspective_reversed_z(fov_y_deg, aspect, near, far):
    """Reversed-Z Vulkan-style projection, matching EditorCamera.cpp:20-39.

    Near plane maps to NDC z=1, far to z=0; Y is flipped (Vulkan clip-space
    Y points down). Returns a row-major (4,4) matrix.
    """
    focal = 1.0 / jnp.tan(jnp.deg2rad(jnp.asarray(fov_y_deg, jnp.float32)) * 0.5)
    n, f = jnp.float32(near), jnp.float32(far)
    z = jnp.zeros(())
    rows = [
        [focal / aspect, z, z, z],
        [z, -focal, z, z],
        [z, z, n / (f - n), n * f / (f - n)],
        [z, z, -jnp.ones(()), z],
    ]
    return jnp.stack([jnp.stack([jnp.asarray(e, jnp.float32) for e in r]) for r in rows])


def look_at(eye, center, up):
    """Right-handed view matrix (camera looks down -Z in view space)."""
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(center, jnp.float32) - eye)
    s = normalize(cross(f, jnp.asarray(up, jnp.float32)))
    u = cross(s, f)
    m = jnp.stack(
        [
            jnp.concatenate([s, -dot(s, eye)[None]]),
            jnp.concatenate([u, -dot(u, eye)[None]]),
            jnp.concatenate([-f, dot(f, eye)[None]]),
            jnp.array([0, 0, 0, 1], jnp.float32),
        ]
    )
    return m


def inverse(m):
    return jnp.linalg.inv(m)


def transform_point(m, p):
    """Apply (4,4) to (...,3) points, returning (...,3) after w-divide-free add."""
    r = mm(p, m[:3, :3].T) + m[:3, 3]
    return r


def transform_point_h(m, p):
    """Apply (4,4) to (...,3) points, returning homogeneous (...,4)."""
    r = mm(p, m[:3, :3].T) + m[:3, 3]
    w = mm(p, m[3, :3].T) + m[3, 3]
    return jnp.concatenate([r, w[..., None]], axis=-1)


def transform_dir(m, d):
    return mm(d, m[:3, :3].T)


def normal_matrix(m):
    """inverse-transpose of the upper 3x3, embedded in a 4x4."""
    n3 = jnp.linalg.inv(m[:3, :3]).T
    out = jnp.eye(4, dtype=jnp.float32)
    return out.at[:3, :3].set(n3)


# ---------------------------------------------------------------------------
# Halton sequence (TAA jitter, EditorCamera.cpp:112-126)
# ---------------------------------------------------------------------------

def halton(index: int, base: int) -> float:
    """Python-time scalar Halton value (matches GetHaltonSequence)."""
    f, r = 1.0, 0.0
    i = int(index)
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton_jitter_sequence(width: int, height: int, phases: int = 16):
    """(phases, 2) NDC-pixel jitter table (EditorCamera::UpdateTAAState).

    jitter = (halton - 0.5) * (2 / viewport) in NDC units; phase index is
    ``frame % 16 + 1``.
    """
    import numpy as np

    out = np.zeros((phases, 2), np.float32)
    for p in range(phases):
        phase = p + 1
        out[p, 0] = (halton(phase, 2) - 0.5) * (2.0 / width)
        out[p, 1] = (halton(phase, 3) - 0.5) * (2.0 / height)
    return jnp.asarray(out)


# ---------------------------------------------------------------------------
# AABB / frustum (SceneCommon.h:17-161 equivalents)
# ---------------------------------------------------------------------------

def aabb_transform(mins, maxs, m):
    """Transform AABBs by matrix m; vectorized over leading dims."""
    center = (mins + maxs) * 0.5
    extent = (maxs - mins) * 0.5
    new_center = transform_point(m, center)
    new_extent = mm(jnp.abs(extent), jnp.abs(m[:3, :3]).T)
    return new_center - new_extent, new_center + new_extent


def frustum_from_viewproj(vp):
    """Gribb-Hartmann plane extraction → (6,4) planes (a,b,c,d), inward.

    Plane order: left, right, bottom, top, near, far. With reversed-Z the
    'near' plane is z_ndc<=1 and 'far' is z_ndc>=0.
    """
    r0, r1, r2, r3 = vp[0], vp[1], vp[2], vp[3]
    planes = jnp.stack(
        [
            r3 + r0,  # left
            r3 - r0,  # right
            r3 + r1,  # bottom
            r3 - r1,  # top
            r2,       # z >= 0   (far, reversed-Z)
            r3 - r2,  # z <= w   (near, reversed-Z)
        ]
    )
    n = jnp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / jnp.maximum(n, 1e-12)


def aabb_outside_frustum(mins, maxs, planes):
    """True where the AABB is fully outside any plane. Vectorized: mins/maxs
    (...,3), planes (6,4) → (...,) bool. Conservative (never culls visible).
    """
    center = (mins + maxs) * 0.5
    extent = (maxs - mins) * 0.5
    # signed distance of center to plane minus projected radius
    d = mm(center, planes[:, :3].T) + planes[:, 3]  # (..., 6)
    r = mm(extent, jnp.abs(planes[:, :3]).T)  # (..., 6)
    return jnp.any(d + r < 0.0, axis=-1)
