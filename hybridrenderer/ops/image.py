"""Shared screen-space image helpers: shifts, bilinear gathers.

The building blocks of the stencil kernels (SVGF/TAA). Border handling is
clamp-to-edge, matching the shaders' coordinate clamps
(e.g. atrous.comp's ``clamp(ipos + offset, 0, size-1)``).
"""
from __future__ import annotations

import jax.numpy as jnp


def shift(img, dy: int, dx: int):
    """Clamp-to-edge shifted view: out[y, x] = img[y+dy, x+dx]."""
    H, W = img.shape[0], img.shape[1]
    ry = max(abs(dy), 1) if dy != 0 else 0
    rx = max(abs(dx), 1) if dx != 0 else 0
    pad = [(ry, ry), (rx, rx)] + [(0, 0)] * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")
    return p[ry + dy: ry + dy + H, rx + dx: rx + dx + W]


def tri_boundary_mask(tri_id, dilate: int = 1):
    """Host-side (numpy) mask of triangle-boundary pixels: True where a
    pixel's winning tri_id differs from any 4-neighbor, dilated by
    ``dilate`` 3×3 rounds.

    Used by the device-vs-CPU golden analysis (bench.py, chip_smoke.py,
    tests/test_golden): device fma/tie-break winner flips can only occur
    where the depth top-2 candidates meet — i.e. along triangle
    boundaries. Any large device-golden error OUTSIDE this mask is a
    genuine raster bug, not a tie-break artifact."""
    import numpy as np

    t = np.asarray(tri_id)
    m = np.zeros(t.shape, bool)
    m[:-1, :] |= t[:-1, :] != t[1:, :]
    m[1:, :] |= t[:-1, :] != t[1:, :]
    m[:, :-1] |= t[:, :-1] != t[:, 1:]
    m[:, 1:] |= t[:, :-1] != t[:, 1:]
    for _ in range(dilate):
        d = m.copy()
        d[:-1, :] |= m[1:, :]
        d[1:, :] |= m[:-1, :]
        d[:, :-1] |= m[:, 1:]
        d[:, 1:] |= m[:, :-1]
        m = d
    return m


def sample_bilinear(img, uv, clamp=True):
    """Bilinear sample of an (H, W, C) or (H, W) image at uv ∈ [0,1]²
    (pixel centers at (i+0.5)/N), clamp-to-edge addressing."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def tap(xi, yi):
        xi = jnp.clip(xi.astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(yi.astype(jnp.int32), 0, H - 1)
        return img[yi, xi]

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    out = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + \
          (c01 * (1 - fx) + c11 * fx) * fy
    return out[..., 0] if squeeze else out


def sample_nearest(img, uv):
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    xi = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
    out = img[yi, xi]
    return out[..., 0] if squeeze else out


def to_pattern_major(img, block: int = 8, grid: int = 4, chunk: int = 4):
    """(H, W, ...) → (Hp·Wp, ...) flat, grouped by interleave pattern.

    Pixels are tiled into ``block``² blocks; a block's pattern id is
    (blockY % grid, blockX % grid). The output orders all pixels of
    pattern 0 first, then pattern 1, … — so fixed-size ray packets drawn
    from consecutive rows see a single pattern (one shared AO direction,
    see ops/sampling.interleaved_cos_hemisphere). Within a pattern,
    same-pattern blocks are ordered in ``chunk``ײ``chunk`` super-tiles so
    one 1024-ray packet covers a compact (block·grid·chunk)² pixel region
    instead of a screen-wide strip — packet traversal cost is the node
    union over the packet's world footprint, so compactness matters as
    much as the shared direction. Pure reshape/transpose: XLA lowers it
    to a strided copy, no gather. Images are edge-padded up to a multiple
    of block·grid·chunk; returns (flat, (Hp, Wp)).
    """
    tile = block * grid * chunk
    H, W = img.shape[:2]
    Hp = -(-H // tile) * tile
    Wp = -(-W // tile) * tile
    pad = [(0, Hp - H), (0, Wp - W)] + [(0, 0)] * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")
    rest = p.shape[2:]
    # axes: (Yc, cy, gy, by, Xc, cx, gx, bx)
    p = p.reshape(Hp // tile, chunk, grid, block,
                  Wp // tile, chunk, grid, block, *rest)
    p = p.transpose(2, 6, 0, 4, 1, 3, 5, 7, *range(8, 8 + len(rest)))
    return p.reshape((Hp * Wp,) + rest), (Hp, Wp)


def from_pattern_major(flat, height: int, width: int, block: int = 8,
                       grid: int = 4, chunk: int = 4):
    """Inverse of :func:`to_pattern_major`; crops the padding back off."""
    tile = block * grid * chunk
    Hp = -(-height // tile) * tile
    Wp = -(-width // tile) * tile
    rest = flat.shape[1:]
    p = flat.reshape(grid, grid, Hp // tile, Wp // tile, chunk, block,
                     chunk, block, *rest)
    p = p.transpose(2, 4, 0, 5, 3, 6, 1, 7, *range(8, 8 + len(rest)))
    return p.reshape((Hp, Wp) + rest)[:height, :width]


def to_tile_major(img, tile_h: int = 32, tile_w: int = 32):
    """(H, W, ...) → (Hp·Wp, ...) flat in tile-major order: pixels of each
    tile_h×tile_w tile are consecutive, tiles in row-major order. Used to
    give ray packets a spatially compact origin footprint (a 1024-ray
    packet = one 32×32 tile instead of a 1024×1 scanline strip). Pure
    reshape/transpose; edge-pads to tile multiples. Returns (flat, (Hp, Wp)).
    """
    H, W = img.shape[:2]
    Hp = -(-H // tile_h) * tile_h
    Wp = -(-W // tile_w) * tile_w
    pad = [(0, Hp - H), (0, Wp - W)] + [(0, 0)] * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")
    rest = p.shape[2:]
    p = p.reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w, *rest)
    p = p.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return p.reshape((Hp * Wp,) + rest), (Hp, Wp)


def from_tile_major(flat, height: int, width: int, tile_h: int = 32,
                    tile_w: int = 32):
    """Inverse of :func:`to_tile_major`; crops the padding back off."""
    Hp = -(-height // tile_h) * tile_h
    Wp = -(-width // tile_w) * tile_w
    rest = flat.shape[1:]
    p = flat.reshape(Hp // tile_h, Wp // tile_w, tile_h, tile_w, *rest)
    p = p.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return p.reshape((Hp, Wp) + rest)[:height, :width]


def upsample2x_depth_aware(val_half, z_half, z_full, sigma_scale=0.1):
    """Joint (depth-guided) bilateral 2× upsample of a half-res signal.

    Each full-res pixel blends the four nearest half-res sample centers
    with bilinear × depth-similarity weights, so low-res AO/GI signals
    upsample without bleeding across depth edges (the standard
    half-resolution ray-effect reconstruction; the SVGF chain after it
    treats the result like any 1-spp signal). ``z_half`` is the linear
    depth of the pixels the half-res signal was traced from (the quad
    representatives), ``z_full`` the full-res linear depth.

    Built from repeats + static shifts only — no gathers.
    """
    H, W = z_full.shape[:2]
    up = jnp.repeat(jnp.repeat(val_half, 2, 0), 2, 1)[:H, :W]
    zu = jnp.repeat(jnp.repeat(z_half, 2, 0), 2, 1)[:H, :W]
    odd_y = (jnp.arange(H)[:, None] & 1).astype(bool)
    odd_x = (jnp.arange(W)[None, :] & 1).astype(bool)

    def quad_neighbor(img, axis):
        # even rows/cols sit in the top/left half of their quad: the
        # nearest neighbor quad is above/left (index −2 in the repeated
        # image); odd rows/cols look below/right (+2)
        par = odd_y if axis == 0 else odd_x
        if img.ndim == 3:
            par = par[..., None]
        if axis == 0:
            return jnp.where(par, shift(img, 2, 0), shift(img, -2, 0))
        return jnp.where(par, shift(img, 0, 2), shift(img, 0, -2))

    taps = (
        (up, zu, 0.75 * 0.75),
        (quad_neighbor(up, 1), quad_neighbor(zu, 1), 0.25 * 0.75),
        (quad_neighbor(up, 0), quad_neighbor(zu, 0), 0.75 * 0.25),
        (quad_neighbor(quad_neighbor(up, 0), 1),
         quad_neighbor(quad_neighbor(zu, 0), 1), 0.25 * 0.25),
    )
    sigma = sigma_scale * jnp.maximum(jnp.abs(z_full), 1e-3)
    chans = up.ndim == 3          # (H, W, C) signals broadcast per pixel
    acc = jnp.zeros_like(up)
    wacc = jnp.zeros_like(z_full)
    for v, z, wb in taps:
        w = wb * jnp.exp(-jnp.abs(z - z_full) / sigma)
        acc = acc + v * (w[..., None] if chans else w)
        wacc = wacc + w
    # all taps rejected (isolated depth sliver): fall back to own quad
    wsafe = jnp.maximum(wacc, 1e-6)
    norm = acc / (wsafe[..., None] if chans else wsafe)
    keep = wacc > 1e-6
    return jnp.where(keep[..., None] if chans else keep, norm, up)


def pixel_uv_grid(height: int, width: int):
    """(H, W, 2) uv at pixel centers — the shaders' ``(ipos+0.5)/size``."""
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    u, v = jnp.meshgrid(xs, ys)
    return jnp.stack([u, v], axis=-1)
