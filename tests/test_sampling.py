"""Reference-matching RNG + sampling distribution tests."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.ops import sampling


def _tea_reference(v0, v1):
    """Independent numpy implementation of InitRandomSeed (common.glsl:51-63)."""
    v0, v1, s0 = np.uint32(v0), np.uint32(v1), np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(16):
            s0 = np.uint32(s0 + np.uint32(0x9E3779B9))
            v0 = np.uint32(v0 + (np.uint32((v1 << np.uint32(4)) + np.uint32(0xA341316C))
                                 ^ np.uint32(v1 + s0)
                                 ^ np.uint32((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))))
            v1 = np.uint32(v1 + (np.uint32((v0 << np.uint32(4)) + np.uint32(0xAD90777D))
                                 ^ np.uint32(v0 + s0)
                                 ^ np.uint32((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))))
    return v0


def test_tea_seed_matches_reference():
    for a, b in [(0, 0), (1, 2), (12345, 678), (2**31, 7)]:
        ours = int(np.asarray(sampling.init_random_seed(
            jnp.uint32(a), jnp.uint32(b))))
        assert ours == int(_tea_reference(a, b))


def test_random_float_range_and_decorrelation():
    seeds = sampling.init_random_seed(jnp.arange(4096, dtype=jnp.uint32),
                                      jnp.uint32(7))
    vals, seeds2 = sampling.random_float(seeds)
    v = np.asarray(vals)
    assert (v >= 0).all() and (v < 1).all()
    assert 0.45 < v.mean() < 0.55
    vals2, _ = sampling.random_float(seeds2)
    assert abs(np.corrcoef(v, np.asarray(vals2))[0, 1]) < 0.05


def test_cos_hemisphere_distribution():
    seeds = sampling.init_random_seed(jnp.arange(8192, dtype=jnp.uint32),
                                      jnp.uint32(3))
    n = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (8192, 1))
    d, _ = sampling.cos_hemisphere_sample(seeds, n)
    d = np.asarray(d)
    assert (d[:, 2] > -1e-6).all()          # upper hemisphere
    # cosine-weighted: E[cos θ] = 2/3
    assert abs(d[:, 2].mean() - 2 / 3) < 0.02
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)


def test_offset_ray_moves_forward():
    p = jnp.array([[1.0, 100.0, 0.001], [-5.0, 0.0, 2.0]])
    n = jnp.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    q = np.asarray(sampling.offset_ray(p, n))
    d = (q - np.asarray(p)) * np.asarray(n)
    assert (d.sum(-1) > 0).all()            # offset along the normal
    assert np.abs(q - np.asarray(p)).max() < 0.01  # but tiny


def test_blue_noise_uniforms_tiling():
    """GetBlueNoise + per-frame offset (common.glsl:86-92, raygen.rgen:29-31):
    values come from the tiled table, the whole table is visited, and the
    per-frame offset shifts the pattern."""
    rng = np.random.default_rng(3)
    tex = jnp.asarray(rng.random((8, 8, 4)).astype(np.float32))
    u0 = np.asarray(sampling.blue_noise_uniforms(tex, 0, 16, 16))
    # frame 0: pure tiling
    np.testing.assert_allclose(u0[:8, :8], np.asarray(tex))
    np.testing.assert_allclose(u0[8:, 8:], np.asarray(tex))
    # frame offset = (123, 456) px rolls the pattern, same value set
    u1 = np.asarray(sampling.blue_noise_uniforms(tex, 1, 16, 16))
    assert not np.allclose(u0, u1)
    np.testing.assert_allclose(
        u1[:8, :8], np.asarray(jnp.roll(tex, (-456 % 8, -123 % 8), (0, 1))))
    assert u0.min() >= 0.0 and u0.max() < 1.0
