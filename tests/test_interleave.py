"""Interleaved AO sampling: pattern relayout + per-pattern directions."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.ops import image as img_ops
from hybridrenderer.ops import sampling


def test_pattern_major_round_trip():
    for (h, w) in [(32, 32), (64, 128), (33, 47), (100, 131)]:
        rng = np.random.default_rng(h * w)
        img = jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32))
        flat, (hp, wp) = img_ops.to_pattern_major(img)
        assert hp % 32 == 0 and wp % 32 == 0
        assert flat.shape == (hp * wp, 3)
        back = img_ops.from_pattern_major(flat, h, w)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(img))


def test_pattern_major_groups_patterns():
    h = w = 128  # multiple of block*grid*chunk: no edge padding
    ys = (np.arange(h) // 8) % 4
    xs = (np.arange(w) // 8) % 4
    pat = (ys[:, None] * 4 + xs[None, :]).astype(np.int32)
    flat, (hp, wp) = img_ops.to_pattern_major(jnp.asarray(pat))
    flat = np.asarray(flat)
    # pattern ids must be non-decreasing: all of pattern 0, then 1, ...
    assert (np.diff(flat) >= 0).all()
    seg = hp * wp // 16
    for p in range(16):
        assert (flat[p * seg:(p + 1) * seg] == p).all()


def test_interleaved_dirs_unit_hemisphere_and_blockwise_constant():
    h = w = 64
    rng = np.random.default_rng(3)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    # same normal everywhere inside one block → identical directions
    n[8:16, 16:24] = np.array([0.0, 1.0, 0.0], np.float32)
    d = np.asarray(sampling.interleaved_cos_hemisphere(jnp.uint32(7),
                                                       jnp.asarray(n)))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert (np.sum(d * n, axis=-1) >= -1e-5).all()
    blk = d[8:16, 16:24].reshape(-1, 3)
    np.testing.assert_allclose(blk, np.broadcast_to(blk[0], blk.shape),
                               atol=1e-6)


def test_interleaved_dirs_rotate_with_frame():
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32),
                         (32, 32, 3))
    d0 = np.asarray(sampling.interleaved_cos_hemisphere(jnp.uint32(0), n))
    d1 = np.asarray(sampling.interleaved_cos_hemisphere(jnp.uint32(1), n))
    assert np.abs(d0 - d1).max() > 1e-3


def test_tile_major_round_trip():
    for (h, w) in [(32, 32), (64, 128), (33, 47), (100, 131)]:
        rng = np.random.default_rng(h + w)
        img = jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32))
        flat, (hp, wp) = img_ops.to_tile_major(img)
        assert flat.shape == (hp * wp, 3)
        back = img_ops.from_tile_major(flat, h, w)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(img))


def test_tile_major_packets_are_tiles():
    h, w = 64, 96
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flat_y, _ = img_ops.to_tile_major(jnp.asarray(ys))
    flat_x, _ = img_ops.to_tile_major(jnp.asarray(xs))
    fy = np.asarray(flat_y).reshape(-1, 1024)
    fx = np.asarray(flat_x).reshape(-1, 1024)
    # every 1024-ray packet spans exactly one 32x32 pixel tile
    assert (fy.max(1) - fy.min(1) == 31).all()
    assert (fx.max(1) - fx.min(1) == 31).all()


def test_shadow_query_layouts_match_flat():
    """Relayouted traversal returns identical visibility (same rays, same
    scene) as the flat path — the relayouts are pure permutations."""
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.ops.trace import SceneTracer
    from hybridrenderer.scene import scene as scenes

    data = scenes.cornell_scene().build()
    tracer = SceneTracer.build(data, RenderSettings(trace_backend="jnp"))
    h = w = 40
    rng = np.random.default_rng(11)
    pos = jnp.asarray(rng.uniform(-1.5, 1.5, (h, w, 3)).astype(np.float32))
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = jnp.asarray(nrm)
    d = sampling.interleaved_cos_hemisphere(jnp.uint32(4), nrm)
    vis_flat = tracer.shadow_query(data, pos, nrm, d, 10.0, layout="flat")
    for layout in ("pattern", "tile"):
        vis = tracer.shadow_query(data, pos, nrm, d, 10.0, layout=layout)
        np.testing.assert_array_equal(np.asarray(vis_flat), np.asarray(vis))
