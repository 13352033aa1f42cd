"""Binned-SAH builder: structural validity + trace equivalence."""
import numpy as np
import jax.numpy as jnp

from hybridrenderer.ops import bvh as bvh_mod
from hybridrenderer.ops import bvh_sah, trace
from hybridrenderer.scene import scene as scenes


def test_sah_structural_and_trace_match():
    data = scenes.cornell_scene().build()
    s = data.triangles
    b = bvh_sah.build_sah(s.v0, s.v1, s.v2)
    assert bvh_mod.validate_bvh(b, s.v0, s.v1, s.v2)

    rng = np.random.default_rng(5)
    R = 512
    v0 = np.asarray(s.v0)
    c = v0.mean(0)
    ext = v0.max(0) - v0.min(0)
    o = jnp.asarray((c + rng.normal(0, 0.5, (R, 3)) * ext).astype(np.float32))
    d = rng.normal(0, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    b_ref = bvh_mod.build_bvh(s.v0, s.v1, s.v2)
    t_ref, tri_ref, _, _ = trace.intersect_bvh(b_ref, s.v0, s.v1, s.v2,
                                               o, d, 1e-3, 1e6)
    t2, tri2, _, _ = trace.intersect_bvh(b, s.v0, s.v1, s.v2, o, d,
                                         1e-3, 1e6)
    hit = np.asarray(tri_ref) >= 0
    np.testing.assert_array_equal(np.asarray(tri2) >= 0, hit)
    np.testing.assert_allclose(np.where(hit, np.asarray(t2), 0),
                               np.where(hit, np.asarray(t_ref), 0),
                               atol=1e-3)


def test_sah_degenerate_identical_centroids():
    # all triangles share a centroid → median fallback path
    v0 = jnp.asarray(np.tile([[0.0, 0, 0]], (16, 1)))
    v1 = jnp.asarray(np.tile([[1.0, 0, 0]], (16, 1)))
    v2 = jnp.asarray(np.tile([[0.0, 1, 0]], (16, 1)))
    b = bvh_sah.build_sah(v0, v1, v2)
    assert bvh_mod.validate_bvh(b, v0, v1, v2)
