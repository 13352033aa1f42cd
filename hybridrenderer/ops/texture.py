"""Texture sampling over the bindless TextureStack.

Replaces `sampler2D textureArray[]` bindless access (common.glsl:30,
GetAlbedo/CalculateNormal/GetEmissive common.glsl:286-311) with gather-
based bilinear filtering over the padded (N, H, W, 4) stack. Wrap mode is
REPEAT (the reference's sampler default).

The classic 4-tap bilinear fetch is 4 separate row gathers per sample.
The quad-texel layout (``build_quads``) bakes each texel's 2x2 bilinear
footprint — REPEAT wrap included — into one (.., 16) row so a bilinear
sample is ONE gather plus vector lerps: 4x the texture memory, 4x fewer
gathers. (The layout was chosen where gathers were priced per row; it
awaits a GPU A/B, ROADMAP D3.)
"""
from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths


def _decode(q):
    """Decode a gathered texel row from its storage dtype.

    u8 storage (HR_TEX_BITS=8, schema.TextureStack.finalized) matches
    the reference's RGBA8 texture formats (ResourceManager.cpp:651-728)
    and shrinks the gather table 4x. Filter math stays f32."""
    if q.dtype == jnp.uint8:
        return q.astype(jnp.float32) * (1.0 / 255.0)
    return q


def spread_gather(table, idx):
    """Row-gather a SMALL table by possibly NEAR-UNIFORM indices without
    replicated-row serialization.

    A gather whose 2M indices are near-uniform (every pixel of a
    surface shares a texture/material/instance id) serializes on the
    repeated row on hardware that gathers per lane. The table is
    replicated 128× (row k of copy j at j*N + k) and indexed by
    flat_element % 128 so neighbouring elements read DISTINCT rows.
    Exact; the copy is table-sized ×128, so use only for KB-scale
    tables. Whether the GPU needs it is open (ROADMAP D3)."""
    N = table.shape[0]
    rep = jnp.tile(table, (128,) + (1,) * (table.ndim - 1))
    flat = idx.reshape(-1)
    lane = jnp.arange(flat.shape[0], dtype=jnp.int32) % 128
    out = rep[lane * N + flat]
    return out.reshape(idx.shape + table.shape[1:])


def _lookup_sizes(sizes, tid):
    """Per-pixel (height, width) f32 for ``tid`` via spread_gather."""
    hw = spread_gather(sizes.astype(jnp.float32), tid)
    return hw[..., 0], hw[..., 1]


def quantize_u8(data):
    """Host-side u8 quantization of a [0,1] texture stack (round-trip
    exact for u8-sourced images; ≤1/510 per channel otherwise).

    Note vs the reference: it loads LDR color textures as
    VK_FORMAT_R8G8B8A8_SRGB (u8 in sRGB space, decoded at sample time,
    ResourceManager.cpp:651-728) while this quantizes the already-linear
    stack — u8-in-linear loses dark-range precision relative to
    u8-in-sRGB. HDR content (values > 1, e.g. LoadHDRTexture's
    R32G32B32A32_SFLOAT) would be clipped, so it is refused here."""
    d = np.asarray(data)
    if np.max(d) > 1.0 + 1e-6:
        from ..runtime.log import core as _log

        _log().warn("HR_TEX_BITS=8 skipped: stack holds HDR texels "
                    "(max %.3g > 1) that u8 would clip", float(np.max(d)))
        return jnp.asarray(d)
    return jnp.asarray(
        np.clip(np.round(d * 255.0), 0.0, 255.0).astype(np.uint8))


def build_quads(data, sizes):
    """Bake the 2x2 bilinear footprint of every texel into one 16-float
    row: quads[n, y, x] = concat(T[y,x], T[y,x+1], T[y+1,x], T[y+1,x+1])
    with the +1 neighbors wrapped by each texture's TRUE size (REPEAT) —
    so the quad path is bit-exact vs the 4-tap path. Host-side, runs
    once at scene build.

    Args: data (N, TH, TW, 4) f32; sizes (N, 2) i32. Returns
    (N, TH, TW, 16) f32.
    """
    d = np.asarray(data)
    sz = np.asarray(sizes)
    n, th, tw, _ = d.shape
    out = np.zeros((n, th, tw, 16), d.dtype)
    for i in range(n):
        h, w = int(sz[i, 0]), int(sz[i, 1])
        t = d[i, :h, :w]
        x1 = np.roll(t, -1, axis=1)
        y1 = np.roll(t, -1, axis=0)
        xy1 = np.roll(x1, -1, axis=0)
        out[i, :h, :w] = np.concatenate([t, x1, y1, xy1], axis=-1)
    return jnp.asarray(out)


def sample_bilinear(stack_data, stack_sizes, tex_id, uv, default):
    """Bilinear sample; tex_id < 0 returns ``default``.

    Args:
      stack_data: (N, TH, TW, 4) f32
      stack_sizes: (N, 2) i32 (height, width) in use
      tex_id: (...,) i32
      uv: (..., 2) f32
      default: (4,) or broadcastable — value where tex_id < 0
    Returns: (..., 4) f32
    """
    tid = jnp.maximum(tex_id, 0)
    h, w = _lookup_sizes(stack_sizes, tid)

    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    flat_mode = _os.environ.get("HR_TEX_GATHER", "flat") == "flat"
    N, TH, TW, C = stack_data.shape
    flat_data = stack_data.reshape(N * TH * TW, C) if flat_mode else None

    def tap(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), w.astype(jnp.int32))
        yi = jnp.mod(yi.astype(jnp.int32), h.astype(jnp.int32))
        if flat_mode:
            # single-operand-dim row gather (see sample_bilinear_quad)
            return _decode(flat_data[(tid * TH + yi) * TW + xi])
        return _decode(stack_data[tid, yi, xi])

    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy

    valid = (tex_id >= 0)[..., None]
    return jnp.where(valid, out, jnp.broadcast_to(default, out.shape))


def sample_bilinear_quad(quads, stack_sizes, tex_id, uv, default):
    """Bilinear sample from the quad-texel layout: ONE row gather per
    sample (vs 4 for :func:`sample_bilinear`); bit-exact same result.

    Args:
      quads: (N, TH, TW, 16) f32 from :func:`build_quads`
      stack_sizes / tex_id / uv / default: as :func:`sample_bilinear`
    Returns: (..., 4) f32
    """
    tid = jnp.maximum(tex_id, 0)
    h, w = _lookup_sizes(stack_sizes, tid)

    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = jnp.mod(x0.astype(jnp.int32), w.astype(jnp.int32))
    yi = jnp.mod(y0.astype(jnp.int32), h.astype(jnp.int32))

    mode = _os.environ.get("HR_TEX_GATHER", "flat")
    if mode != "nd":
        # ONE-dimensional row gather: pre-flattening the (tid, yi, xi)
        # advanced index makes this the same op shape as every other
        # row gather in the frame (same rows, bit-identical)
        N, TH, TW, C = quads.shape
        flat = quads.reshape(N * TH * TW, C)
        idx = (tid * TH + yi) * TW + xi
        if mode == "u16" and flat.dtype == jnp.float32:
            # EXACT f32 via two u16 gathers (the shade_rows encoding):
            # probe for hardware whose 16-bit gathers run faster.
            pair = jax.lax.bitcast_convert_type(flat, jnp.uint16)
            lo_t = pair[..., 0]
            hi_t = pair[..., 1]
            hi = hi_t[idx].astype(jnp.uint32)
            lo = lo_t[idx].astype(jnp.uint32)
            q = jax.lax.bitcast_convert_type(
                (hi << 16) | lo, jnp.float32)
        elif mode == "bf16" and flat.dtype == jnp.float32:
            # single bf16 gather (≤0.2% relative texel error — below
            # the u8 source quantization)
            q = flat.astype(jnp.bfloat16)[idx].astype(jnp.float32)
        elif mode == "barrier":
            # probe: materialize index + table before the gather
            idx, flat = jax.lax.optimization_barrier((idx, flat))
            q = flat[idx]
        elif mode == "obar":
            # probe: barrier the gather on BOTH sides — forces a
            # standalone gather op instead of a gather-inside-fusion
            idx = jax.lax.optimization_barrier(idx)
            q = jax.lax.optimization_barrier(flat[idx])
        else:
            q = flat[idx]
    else:
        q = quads[tid, yi, xi]                  # the one gather
    q = _decode(q)
    top = q[..., 0:4] * (1 - fx) + q[..., 4:8] * fx
    bot = q[..., 8:12] * (1 - fx) + q[..., 12:16] * fx
    out = top * (1 - fy) + bot * fy

    valid = (tex_id >= 0)[..., None]
    return jnp.where(valid, out, jnp.broadcast_to(default, out.shape))


WINDOW_WS = 8       # window texels per axis
WINDOW_STRIDE = 4   # window origin stride (overlap WS - STRIDE)
WINDOW_GY = 4       # pixel group shape (image-mode sampling)
WINDOW_GX = 4


def build_window_atlas(data, sizes):
    """Overlapping-window atlas for group-window sampling: every
    STRIDE-aligned origin gets a WS×WS texel window with REPEAT wrap
    baked in — (N·NWY·NWX, WS·WS·4) f32, 4× texel memory (the same
    multiplier as build_quads). One atlas row then serves a whole
    4×4-pixel group's bilinear taps, cutting the per-pixel sample
    gather count 16×. Host-side, runs once at scene build."""
    d = np.asarray(data)
    sz = np.asarray(sizes)
    n, th, tw, c = d.shape
    ws, stride = WINDOW_WS, WINDOW_STRIDE
    nwy, nwx = max(1, th // stride), max(1, tw // stride)
    atlas = np.zeros((n, nwy, nwx, ws, ws, c), d.dtype)
    for i in range(n):
        h, w = int(sz[i, 0]), int(sz[i, 1])
        t = d[i, :h, :w]
        for a in range(min(nwy, -(-h // stride))):
            ys = (a * stride + np.arange(ws)) % h
            rows = t[ys]
            for b in range(min(nwx, -(-w // stride))):
                xs = (b * stride + np.arange(ws)) % w
                atlas[i, a, b] = rows[:, xs]
    return (jnp.asarray(atlas.reshape(n * nwy * nwx, ws * ws * c)),
            nwy, nwx)


def sample_window(textures, tex_id, uv, default):
    """Group-window bilinear over (H, W) image-shaped queries: one
    1 KB row gather per 4×4 pixel group + separable one-hot weight
    contractions. Matches sample_bilinear whenever the group's texel
    span fits the window (texels-per-pixel ≲ 1 per axis; REPEAT-seam
    straddles handled by centered wrapped deltas); wider spans clamp
    to the window edge (minification — mips are the structural fix).
    The weight contractions run at full f32 precision."""
    atlas, nwy, nwx = textures.windows
    H, W = tex_id.shape
    GY, GX, WS, STRIDE = WINDOW_GY, WINDOW_GX, WINDOW_WS, WINDOW_STRIDE
    Gy, Gx = H // GY, W // GX
    C = 4
    sizes = textures.sizes

    tid = jnp.maximum(tex_id, 0)
    h, w = _lookup_sizes(sizes, tid)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0).astype(jnp.float32)
    fy = (y - y0).astype(jnp.float32)
    hi = h.astype(jnp.int32)
    wi = w.astype(jnp.int32)
    xi = jnp.mod(x0.astype(jnp.int32), wi)
    yi = jnp.mod(y0.astype(jnp.int32), hi)

    def to_groups(a):
        return a.reshape(Gy, GY, Gx, GX) \
                .transpose(0, 2, 1, 3).reshape(Gy * Gx, GY * GX)

    xig, yig = to_groups(xi), to_groups(yi)
    fxg, fyg = to_groups(fx), to_groups(fy)
    tg = to_groups(tid)[:, 0]
    hg = to_groups(hi)[:, 0]
    wg = to_groups(wi)[:, 0]

    def origin_off(cg, size):
        # circular-aware group min via centered wrapped deltas from
        # pixel 0 (REPEAT-seam straddles resolve correctly)
        delta = jnp.mod(cg - cg[:, :1] + size[:, None] // 2,
                        size[:, None]) - size[:, None] // 2
        cmin = cg[:, 0] + delta.min(1)
        origin = (cmin // STRIDE) * STRIDE
        widx = jnp.mod(origin, size) // STRIDE
        off = jnp.clip(cg[:, :1] + delta - origin[:, None], 0, WS - 2)
        return widx, off

    wyx, offy = origin_off(yig, hg)
    wxx, offx = origin_off(xig, wg)
    row = atlas[(tg * nwy + wyx) * nwx + wxx]       # THE gather (G rows)
    win = row.reshape(-1, WS, WS * C)

    pos = jnp.arange(WS, dtype=jnp.int32)[None, None, :]
    wym = jnp.where(pos == offy[..., None], 1.0 - fyg[..., None], 0.0) \
        + jnp.where(pos == offy[..., None] + 1, fyg[..., None], 0.0)
    wxm = jnp.where(pos == offx[..., None], 1.0 - fxg[..., None], 0.0) \
        + jnp.where(pos == offx[..., None] + 1, fxg[..., None], 0.0)

    t1 = jnp.einsum("gpy,gyz->gpz", wym, win,
                    preferred_element_type=jnp.float32,
                    precision=maths.HIGHEST)
    t1 = t1.reshape(-1, GY * GX, WS, C)
    out = jnp.sum(wxm[..., None] * t1, axis=2)      # (G, P, C)

    res = out.reshape(Gy, Gx, GY, GX, C).transpose(0, 2, 1, 3, 4) \
             .reshape(H, W, C)
    valid = (tex_id >= 0)[..., None]
    return jnp.where(valid, res, jnp.broadcast_to(default, res.shape))


def sample_stack(textures, tex_id, uv, default):
    """Bilinear sample a TextureStack: the group-window path when the
    stack carries a window atlas AND the query is image-shaped with
    group-divisible dims, else the one-gather quad path, else 4-tap.

    HR_TEX_STUB=1 (diagnostic): skip the fetch entirely and return
    ``default`` everywhere — prices the sample SITE minus the gather
    (in-frame textured bisect, r5)."""
    if _os.environ.get("HR_TEX_STUB", "0") == "1":
        shape = tex_id.shape + (4,)
        return jnp.broadcast_to(default, shape) + uv[..., :1] * 0.0
    if getattr(textures, "windows", None) is not None \
            and jnp.ndim(tex_id) == 2 \
            and tex_id.shape[0] % WINDOW_GY == 0 \
            and tex_id.shape[1] % WINDOW_GX == 0:
        return sample_window(textures, tex_id, uv, default)
    if getattr(textures, "quads", None) is not None:
        return sample_bilinear_quad(
            textures.quads, textures.sizes, tex_id, uv, default)
    return sample_bilinear(textures.data, textures.sizes, tex_id, uv,
                           default)


def sample_nearest(stack_data, stack_sizes, tex_id, uv, default):
    tid = jnp.maximum(tex_id, 0)
    hf, wf = _lookup_sizes(stack_sizes, tid)
    h = hf.astype(jnp.int32)
    w = wf.astype(jnp.int32)
    xi = jnp.mod((uv[..., 0] * wf).astype(jnp.int32), w)
    yi = jnp.mod((uv[..., 1] * hf).astype(jnp.int32), h)
    out = _decode(stack_data[tid, yi, xi])
    valid = (tex_id >= 0)[..., None]
    return jnp.where(valid, out, jnp.broadcast_to(default, out.shape))
