"""Monte-Carlo sampling utilities with reference-matching RNG.

The TEA-style hash seed (common.glsl:51-63 InitRandomSeed) and the
xorshift-multiply float generator (common.glsl:65-73 RandomFloat) are
reproduced bit-exactly in uint32 so per-pixel noise patterns match the
reference's 1-spp signals — important for SVGF parity testing. Hemisphere,
cone, triangle and light-CDF sampling mirror common.glsl:75-100, 223-278.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import maths
from ..core.types import INVALID_ID

PI = 3.14159265359

_U32 = jnp.uint32


def init_random_seed(val0, val1):
    """TEA 16-round hash (common.glsl:51-63). Inputs any uint32 arrays."""
    v0 = jnp.asarray(val0).astype(_U32)
    v1 = jnp.asarray(val1).astype(_U32)
    s0 = _U32(0)
    for _ in range(16):
        s0 = s0 + _U32(0x9E3779B9)
        v0 = v0 + (
            ((v1 << 4) + _U32(0xA341316C))
            ^ (v1 + s0)
            ^ ((v1 >> 5) + _U32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + _U32(0xAD90777D))
            ^ (v0 + s0)
            ^ ((v0 >> 5) + _U32(0x7E95761E))
        )
    return v0


def random_float(seed):
    """(value, new_seed) — common.glsl:65-73. seed: uint32 array."""
    seed = (seed ^ _U32(61)) ^ (seed >> 16)
    seed = seed * _U32(9)
    seed = seed ^ (seed >> 4)
    seed = seed * _U32(0x27D4EB2D)
    seed = seed ^ (seed >> 15)
    return seed.astype(jnp.float32) / 4294967296.0, seed


def _cosine_dir(r1, r2, normal):
    """Cosine-weighted direction about ``normal`` from uniforms (r1, r2)
    — the frame construction of common.glsl:75-84."""
    r = jnp.sqrt(r1)
    phi = 2.0 * PI * r2
    helper = jnp.where(
        (jnp.abs(normal[..., 0]) > 0.1)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), normal.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32), normal.shape),
    )
    tangent = maths.normalize(maths.cross(normal, helper))
    bitangent = maths.cross(normal, tangent)
    d = (
        tangent * (r * jnp.cos(phi))[..., None]
        + bitangent * (r * jnp.sin(phi))[..., None]
        + normal * jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))[..., None]
    )
    return maths.normalize(d)


def cos_hemisphere_from_uniforms(r1, r2, normal):
    """Cosine-weighted direction from explicit uniforms (e.g. blue-noise
    draws, common.glsl:75-84 with raygen.rgen's randSample)."""
    return _cosine_dir(r1, r2, normal)


def cos_hemisphere_sample(seed, normal):
    """Cosine-weighted hemisphere direction (common.glsl:75-84).

    Returns (direction, new_seed); consumes two RandomFloat draws in the
    reference's order.
    """
    r1, seed = random_float(seed)
    r2, seed = random_float(seed)
    return _cosine_dir(r1, r2, normal), seed


def interleaved_cos_hemisphere(frame_index, normal, block: int = 8,
                               grid: int = 4, salt: int = 0x51AB7000):
    """Interleaved-pattern cosine hemisphere directions over an (H, W)
    screen — the direction-coherent AO sampler.

    One (r1, r2) uniform pair is drawn per *pattern* per frame (pattern id
    = (blockY % grid) * grid + blockX % grid over ``block``² pixel blocks,
    GTAO-style interleaved sampling) and shared by every pixel of that
    pattern, then aligned to each pixel's own normal frame. Combined with
    the pattern-major ray relayout (ops/image.to_pattern_major) this makes
    each traversal packet carry essentially ONE local direction — packet
    traversal cost collapses from incoherent-AO to shadow-ray levels.
    Temporal rotation: the per-pattern seeds re-hash every frame, and SVGF
    temporal accumulation (history length ≤ 32) integrates the rotations,
    so converged AO matches the per-pixel sampler in distribution
    (variance is spatially structured per block instead of white).
    Replaces the per-pixel draw of rt_shadow.rgen:85-96; disable with
    RenderSettings.ao_interleaved=False for reference-pattern parity.
    """
    H, W = normal.shape[:2]
    P = grid * grid
    pat = jnp.arange(P, dtype=jnp.uint32)
    # ``salt`` decorrelates consumers (AO vs GI) drawing per-pattern
    # uniforms in the same frame
    seed = init_random_seed(pat + _U32(salt), frame_index)
    r1, seed = random_float(seed)
    r2, seed = random_float(seed)

    def expand(v):
        tile = jnp.repeat(jnp.repeat(v.reshape(grid, grid), block, 0),
                          block, 1)
        reps = (-(-H // (grid * block)), -(-W // (grid * block)))
        return jnp.tile(tile, reps)[:H, :W]

    return _cosine_dir(expand(r1), expand(r2), normal)


def blue_noise_uniforms(blue_noise, frame_index, H: int, W: int):
    """Per-pixel vec4 uniforms from the tiled blue-noise texture.

    GetBlueNoise (common.glsl:86-92) fetched at
    ``pixel + frame * (123, 456)`` — the per-frame temporal offset of
    raygen.rgen:29-31. ``blue_noise``: (Hn, Wn, 4) f32 in [0, 1).
    The table is tiny (64² × 16 B = 64 KB), far below the ~2 MB
    small-table gather cliff, so this is a cheap XLA gather.
    """
    Hn, Wn = blue_noise.shape[:2]
    fi = jnp.asarray(frame_index, jnp.int32)
    ys = (jnp.arange(H, dtype=jnp.int32)[:, None] + fi * 456) % Hn
    xs = (jnp.arange(W, dtype=jnp.int32)[None, :] + fi * 123) % Wn
    return blue_noise[ys, xs]


def square_to_uniform_cone(u, cos_theta_max):
    """common.glsl:94-100."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = u[..., 1] * 2.0 * PI
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def sample_triangle_uv(u):
    """Uniform triangle barycentric (common.glsl:223-226)."""
    r = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - r, u[..., 1] * r], axis=-1)


def sample_discrete_cdf(cdf, start, count, rand_val, max_count: int = 32):
    """Per-element binary search in a CDF segment (common.glsl:228-243).

    cdf: (C,) global concatenated CDF; start/count: (...,) segment bounds;
    rand_val: (...,) uniforms. ``max_count`` bounds the bisection depth
    (2^max_count elements).
    """
    last = jnp.maximum(start + count - 1, 0)
    max_val = cdf[last]
    x = rand_val * max_val

    low = start
    high = start + count
    for _ in range(max_count):
        needed = low < high
        mid = low + (high - low) // 2
        ge = x >= cdf[jnp.clip(mid, 0, cdf.shape[0] - 1)]
        low = jnp.where(needed & ge, mid + 1, low)
        high = jnp.where(needed & (~ge), mid, high)
    return jnp.clip(low - start, 0, jnp.maximum(count - 1, 0))


def sample_lights(scene, position, seed):
    """SampleLights (common.glsl:250-278): pick a light uniformly, then an
    emissive triangle by area-CDF, then a point on it; returns
    (direction, sampled_instance, new_seed). Zero lights → zero direction.
    """
    L = scene.lights.count
    shape = position.shape[:-1]
    if L == 0:
        return (jnp.zeros(position.shape, jnp.float32),
                jnp.full(shape, INVALID_ID, jnp.int32), seed)

    rand_l, seed = random_float(seed)
    rand_el, seed = random_float(seed)
    ru, seed = random_float(seed)
    rv, seed = random_float(seed)
    rand_uv = jnp.stack([ru, rv], axis=-1)

    light_id = jnp.clip((rand_l * L).astype(jnp.int32), 0, L - 1)
    # few-light scenes make light_id NEAR-UNIFORM across 2M pixels —
    # plain tiny-table gathers serialize on the replicated row
    # (ops/texture.spread_gather, r5); one packed spread lookup instead
    from .texture import spread_gather as _sg

    lrow = _sg(jnp.stack([scene.lights.instance,
                          scene.lights.environment,
                          scene.lights.cdf_start,
                          scene.lights.cdf_count], axis=-1), light_id)
    inst = lrow[..., 0]
    env = lrow[..., 1]

    # area-light branch
    elem = sample_discrete_cdf(
        scene.lights.cdf, lrow[..., 2], lrow[..., 3], rand_el)
    tri_uv = sample_triangle_uv(rand_uv)

    # global triangle index of that element within the instance's range:
    # instance rows store index_offset/3 = first primitive id
    safe_inst = jnp.maximum(inst, 0)
    prim0 = scene.instances.index_offset[safe_inst] // 3
    tri = prim0 + elem
    p0 = scene.triangles.v0[tri]
    p1 = scene.triangles.v1[tri]
    p2 = scene.triangles.v2[tri]
    light_pos = (
        p1 * tri_uv[..., 0:1] + p2 * tri_uv[..., 1:2]
        + p0 * (1.0 - tri_uv[..., 0:1] - tri_uv[..., 1:2])
    )
    dir_area = maths.normalize(light_pos - position)

    # environment-light branch: uniform sphere (common.glsl:267-275)
    z = 2.0 * rand_uv[..., 0] - 1.0
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * rand_uv[..., 1]
    dir_env = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)

    is_area = (inst != INVALID_ID)[..., None]
    is_env = (env != INVALID_ID)[..., None]
    direction = jnp.where(is_area, dir_area, jnp.where(is_env, dir_env, 0.0))
    sampled = jnp.where(inst != INVALID_ID, inst, INVALID_ID)
    return direction, sampled, seed


def offset_ray(p, n):
    """Self-intersection-safe ray origin offset (common.glsl:155-167),
    reproduced with the same integer-ulp stepping."""
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0

    of_i = (int_scale * n).astype(jnp.int32)
    p_bits = jax_bitcast_f2i(p)
    stepped = p_bits + jnp.where(p < 0, -of_i, of_i)
    p_int = jax_bitcast_i2f(stepped)
    return jnp.where(jnp.abs(p) < origin, p + float_scale * n, p_int)


def jax_bitcast_f2i(x):
    import jax.lax as lax
    return lax.bitcast_convert_type(x, jnp.int32)


def jax_bitcast_i2f(x):
    import jax.lax as lax
    return lax.bitcast_convert_type(x, jnp.float32)
