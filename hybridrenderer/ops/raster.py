"""Software rasterizer — visibility-buffer style, jnp reference version.

Software replacement for the hardware raster stages driven by
gbuffer.vert / DepthPrepass / GBufferPass (GBufferPass.cpp:13-139). The
design splits rasterization:

  1. vertex transform + near-plane clip   (this file, dense jnp)
  2. coverage / depth resolve → (tri_id, barycentrics, depth) per pixel
     (this file: full-screen chunked scan; ops/raster_tile.py: the
     binned tile kernel with identical contract)
  3. deferred attribute interpolation + material fetch (ops/gbuffer.py)

Stage 2 outputs *perspective-correct barycentrics with respect to the
original (unclipped) triangle*, so stage 3 never needs to know clipping
happened. Depth is reversed-Z NDC (near=1, far=0) and the depth test is a
max-resolve, matching the reference's reversed-Z pipeline
(EditorCamera.cpp:30-39, DepthPrepass clear to 0.0).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from ..core.maths import HIGHEST

W_CLIP = 1e-4  # near-plane clip epsilon in w (w = -z_view)
AREA_EPS = 1e-12


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ClippedTriangles:
    """Post-clip screen-space triangle set (static 2T slots)."""

    sxy: Any      # (T2, 3, 2) screen coords (pixel units)
    z: Any        # (T2, 3) NDC depth (reversed-Z)
    inv_w: Any    # (T2, 3) 1/w_clip
    bary: Any     # (T2, 3, 3) barycentrics w.r.t. the original triangle
    tri_id: Any   # (T2,) original triangle index
    valid: Any    # (T2,) bool


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class VisibilityBuffer:
    """Per-pixel raster result; the contract between raster and G-buffer."""

    tri_id: Any  # (H, W) i32, -1 = background
    bary1: Any   # (H, W) f32 perspective-correct original barycentric of v1
    bary2: Any   # (H, W) f32 ... of v2
    depth: Any   # (H, W) f32 reversed-Z NDC (0 = background/far)


def transform_to_clip(world_pos, view_proj, jitter=None):
    """World → clip with optional TAA jitter (gbuffer.vert:44-45 applies
    ``pos.xy += jitter * w`` after projection)."""
    clip = jnp.matmul(world_pos, view_proj[:3, :3].T,
                      precision=HIGHEST) + view_proj[:3, 3]
    w = jnp.matmul(world_pos, view_proj[3, :3].T,
                   precision=HIGHEST) + view_proj[3, 3]
    clip4 = jnp.concatenate([clip, w[..., None]], axis=-1)
    if jitter is not None:
        clip4 = clip4.at[..., :2].add(jitter[None, :] * w[..., None])
    return clip4


# 8-entry permutation LUT indexed by the in-front bitmask m = in0|in1<<1|in2<<2.
# Rotation puts "in" vertices first while preserving winding.
import numpy as _np

_PERM = _np.array(
    [
        [0, 1, 2],  # 0: none in (degenerate)
        [0, 1, 2],  # 1: v0 in
        [1, 2, 0],  # 2: v1 in
        [0, 1, 2],  # 3: v0,v1 in (v2 out, already last)
        [2, 0, 1],  # 4: v2 in
        [2, 0, 1],  # 5: v2,v0 in (v1 out → last after rotation)
        [1, 2, 0],  # 6: v1,v2 in (v0 out → last)
        [0, 1, 2],  # 7: all in
    ],
    _np.int32,
)  # numpy on purpose: a module-level jnp.array would initialize the
   # device backend at import time (breaks CPU-mesh forcing)


def clip_triangles(clip_verts, i0, i1, i2, width, height,
                   tri_mask=None, single_sided=None,
                   corners=None) -> ClippedTriangles:
    """Near-plane (w >= W_CLIP) clip producing 2 static output slots per
    input triangle. Clipped vertices carry original-triangle barycentrics
    so downstream interpolation is clip-agnostic.

    ``single_sided`` (T,) bool enables back-face culling of those
    triangles by screen-space winding (the reference forward pipeline's
    VK_CULL_MODE_BACK_BIT, ForwardPass.cpp:45; its G-buffer uses
    CULL_NONE, GBufferPass.cpp:74, to keep foliage two-sided — matched
    by never marking cut-out materials single-sided). For closed opaque
    meshes the image is identical and live raster candidates roughly
    halve."""
    if corners is not None:
        # gather-free path: per-corner clip positions were computed from
        # the triangle soup's corner tables (soup.v0/v1/v2), skipping
        # three T-row vertex gathers
        v = corners                                              # (T,3,4)
        T = v.shape[0]
    else:
        T = i0.shape[0]
        v = jnp.stack([clip_verts[i0], clip_verts[i1], clip_verts[i2]],
                      axis=1)                                    # (T,3,4)
    w = v[..., 3]
    infront = w >= W_CLIP  # (T, 3)
    m = (infront[:, 0].astype(jnp.int32)
         + 2 * infront[:, 1].astype(jnp.int32)
         + 4 * infront[:, 2].astype(jnp.int32))
    n_in = jnp.sum(infront, axis=1)

    perm = jnp.asarray(_PERM)[m]  # (T, 3)
    # gather-free permutation: perm only takes 3 values per slot, so the
    # corner pick is a one-hot contraction
    oh = (perm[:, :, None]
          == jnp.arange(3, dtype=perm.dtype)[None, None, :])     # (T,3,3)
    u = jnp.einsum("tkj,tjc->tkc", oh.astype(v.dtype), v,
                   precision=HIGHEST)                            # (T,3,4)
    # the permuted seed barycentric rows ARE the one-hot rows (eye[perm])
    ub = oh.astype(jnp.float32)                                  # (T,3,3)

    def lerp_to_plane(a, ab, b, bb):
        # intersect edge a→b with w = W_CLIP
        t = (a[..., 3] - W_CLIP) / jnp.where(
            jnp.abs(a[..., 3] - b[..., 3]) < 1e-12, 1e-12, a[..., 3] - b[..., 3]
        )
        t = jnp.clip(t, 0.0, 1.0)[..., None]
        return a + t * (b - a), ab + t * (bb - ab)

    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
    b0, b1, b2 = ub[:, 0], ub[:, 1], ub[:, 2]

    # TWO_IN (u2 out): crossings a on u1→u2, b on u0→u2
    a2, ab2 = lerp_to_plane(u1, b1, u2, b2)
    c2, cb2 = lerp_to_plane(u0, b0, u2, b2)
    # ONE_IN (u0 in): crossings a on u0→u1, b on u0→u2
    a1, ab1 = lerp_to_plane(u0, b0, u1, b1)
    c1, cb1 = lerp_to_plane(u0, b0, u2, b2)

    two_in = (n_in == 2)[:, None]
    one_in = (n_in == 1)[:, None]
    full = (n_in == 3)[:, None]

    def sel(va, vb, vc):  # select per case: full / two_in / one_in
        return jnp.where(full, va, jnp.where(two_in, vb, vc))

    # slot A: full → (u0,u1,u2); two_in → (u0,u1,a2); one_in → (u0,a1,c1)
    A0, A0b = u0, b0
    A1 = sel(u1, u1, a1)
    A1b = sel(b1, b1, ab1)
    A2 = sel(u2, a2, c1)
    A2b = sel(b2, ab2, cb1)
    validA = n_in > 0
    # slot B: two_in → (u0,a2,c2); else degenerate
    B0, B0b = u0, b0
    B1, B1b = a2, ab2
    B2, B2b = c2, cb2
    validB = n_in == 2

    pos = jnp.concatenate(
        [jnp.stack([A0, A1, A2], axis=1), jnp.stack([B0, B1, B2], axis=1)], axis=0
    )  # (2T, 3, 4)
    bary = jnp.concatenate(
        [jnp.stack([A0b, A1b, A2b], axis=1), jnp.stack([B0b, B1b, B2b], axis=1)],
        axis=0,
    )
    valid = jnp.concatenate([validA, validB], axis=0)
    if tri_mask is not None:
        valid = valid & jnp.concatenate([tri_mask, tri_mask], axis=0)
    tri_id = jnp.concatenate(
        [jnp.arange(T, dtype=jnp.int32), jnp.arange(T, dtype=jnp.int32)]
    )

    # project to screen space (pixel units); Vulkan-style NDC y-down is
    # already baked into the projection's Y flip.
    wv = jnp.maximum(pos[..., 3], W_CLIP * 0.5)
    inv_w = 1.0 / wv
    ndc = pos[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (ndc[..., 1] * 0.5 + 0.5) * height
    if single_sided is not None:
        # screen-space winding: front faces (geometric normal toward the
        # camera, CCW in world) have NEGATIVE signed area in y-down
        # screen coordinates. Clipping preserves winding, so post-clip
        # slots are tested directly.
        e1x = sx[:, 1] - sx[:, 0]
        e1y = sy[:, 1] - sy[:, 0]
        e2x = sx[:, 2] - sx[:, 0]
        e2y = sy[:, 2] - sy[:, 0]
        area2 = e1x * e2y - e1y * e2x
        ss2 = jnp.concatenate([single_sided, single_sided], axis=0)
        valid = valid & ~(ss2 & (area2 > 0.0))
    return ClippedTriangles(
        sxy=jnp.stack([sx, sy], axis=-1),
        z=ndc[..., 2],
        inv_w=inv_w,
        bary=bary,
        tri_id=tri_id,
        valid=valid,
    )


def _edge_coeffs(pa, pb):
    """Linear form of edge function cross(b-a, p-a): e = αx + βy + γ."""
    alpha = -(pb[..., 1] - pa[..., 1])
    beta = pb[..., 0] - pa[..., 0]
    gamma = (pb[..., 1] - pa[..., 1]) * pa[..., 0] - (pb[..., 0] - pa[..., 0]) * pa[..., 1]
    return alpha, beta, gamma


def _candidate_edges(sxy, px, py):
    """Sign-corrected edge values (e0, e1, e2) of candidates ``sxy``
    (..., 3, 2) at pixel centers (px, py), and |2·area|. Both windings
    raster: clockwise candidates get their edges flipped."""
    p0, p1, p2 = sxy[..., 0, :], sxy[..., 1, :], sxy[..., 2, :]
    a0, b0c, g0 = _edge_coeffs(p1, p2)  # opposite v0
    a1, b1c, g1 = _edge_coeffs(p2, p0)
    a2, b2c, g2 = _edge_coeffs(p0, p1)
    area2 = g0 + a0 * p0[..., 0] + b0c * p0[..., 1]
    sgn = jnp.where(area2 < 0, -1.0, 1.0)

    def ev(al, be, ga):
        return sgn * (al * px + be * py + ga)

    return ev(a0, b0c, g0), ev(a1, b1c, g1), ev(a2, b2c, g2), \
        jnp.abs(area2)


def _original_barycentrics(l0, l1, l2, inv_w, bary):
    """Perspective-correct barycentrics w.r.t. the ORIGINAL triangle from
    screen-space weights l_i of a (possibly clipped) candidate."""
    u0 = l0 * inv_w[..., 0]
    u1 = l1 * inv_w[..., 1]
    u2 = l2 * inv_w[..., 2]
    s = jnp.maximum(u0 + u1 + u2, 1e-20)
    pc0, pc1, pc2 = u0 / s, u1 / s, u2 / s
    ob1 = pc0 * bary[..., 0, 1] + pc1 * bary[..., 1, 1] \
        + pc2 * bary[..., 2, 1]
    ob2 = pc0 * bary[..., 0, 2] + pc1 * bary[..., 1, 2] \
        + pc2 * bary[..., 2, 2]
    return ob1, ob2


def candidate_barycentrics(sxy, inv_w, bary, px, py):
    """(bary1, bary2) of candidates at pixel centers — the per-candidate
    math of ``rasterize``, for a resolve stage that knows the winner."""
    e0, e1, e2, area2 = _candidate_edges(sxy, px, py)
    inv_area = 1.0 / jnp.maximum(area2, AREA_EPS)
    return _original_barycentrics(e0 * inv_area, e1 * inv_area,
                                  e2 * inv_area, inv_w, bary)


@partial(jax.jit, static_argnames=("width", "height", "chunk"))
def rasterize(tris: ClippedTriangles, width: int, height: int,
              chunk: int = 64) -> VisibilityBuffer:
    """Full-screen chunked coverage/depth resolve (reference path).

    Scans triangles in chunks of ``chunk``; per chunk evaluates the three
    edge functions over all pixels, max-resolves reversed-Z depth, and
    carries (depth, tri, bary). O(T·H·W) — the correctness baseline the
    binned tile kernel (ops/raster_tile.py) is tested against.
    """
    T2 = tris.tri_id.shape[0]
    n_chunks = max(1, -(-T2 // chunk))
    pad = n_chunks * chunk - T2

    def pad0(x):
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg)

    sxy = pad0(tris.sxy).reshape(n_chunks, chunk, 3, 2)
    zs = pad0(tris.z).reshape(n_chunks, chunk, 3)
    inv_w = pad0(tris.inv_w).reshape(n_chunks, chunk, 3)
    bary = pad0(tris.bary).reshape(n_chunks, chunk, 3, 3)
    tri_id = pad0(tris.tri_id).reshape(n_chunks, chunk)
    valid = pad0(tris.valid).reshape(n_chunks, chunk)

    px = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]

    def chunk_step(carry, inp):
        best_z, best_tri, best_b1, best_b2 = carry
        c_sxy, c_z, c_iw, c_bary, c_id, c_valid = inp

        e0, e1, e2, area2 = _candidate_edges(
            c_sxy[:, None, None], px[None], py[None])

        live = c_valid[:, None, None] & (area2 > AREA_EPS)
        cover = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & live
        inv_area = 1.0 / jnp.maximum(area2, AREA_EPS)
        l0 = e0 * inv_area
        l1 = e1 * inv_area
        l2 = e2 * inv_area
        z = (
            l0 * c_z[:, 0, None, None]
            + l1 * c_z[:, 1, None, None]
            + l2 * c_z[:, 2, None, None]
        )
        cover = cover & (z >= 0.0) & (z <= 1.0)
        zc = jnp.where(cover, z, -1.0)

        # winner within chunk (first max), selected with a one-hot mask
        win = jnp.argmax(zc, axis=0)                      # (H, W)
        win_z = jnp.max(zc, axis=0)                       # (H, W)
        onehot = (jnp.arange(zc.shape[0], dtype=jnp.int32)[:, None, None]
                  == win[None])                           # (C, H, W) bool

        def sel(x):  # (C, H, W) → winner's value
            return jnp.sum(jnp.where(onehot, x, 0.0), axis=0)

        ob1_all, ob2_all = _original_barycentrics(
            l0, l1, l2, c_iw[:, None, None], c_bary[:, None, None])
        ob1 = sel(ob1_all)
        ob2 = sel(ob2_all)
        win_tri = jnp.sum(
            jnp.where(onehot, c_id[:, None, None], 0), axis=0).astype(jnp.int32)

        take = win_z > best_z
        best_b1 = jnp.where(take, ob1, best_b1)
        best_b2 = jnp.where(take, ob2, best_b2)
        best_tri = jnp.where(take, win_tri, best_tri)
        best_z = jnp.where(take, win_z, best_z)
        return (best_z, best_tri, best_b1, best_b2), None

    init = (
        jnp.zeros((height, width), jnp.float32),
        jnp.full((height, width), -1, jnp.int32),
        jnp.zeros((height, width), jnp.float32),
        jnp.zeros((height, width), jnp.float32),
    )
    (z, tri, b1, b2), _ = jax.lax.scan(
        chunk_step, init, (sxy, zs, inv_w, bary, tri_id, valid)
    )
    background = tri < 0
    return VisibilityBuffer(
        tri_id=jnp.where(background, -1, tri),
        bary1=jnp.where(background, 0.0, b1),
        bary2=jnp.where(background, 0.0, b2),
        depth=jnp.where(background, 0.0, z),
    )


def rasterize_scene(world_pos, i0, i1, i2, cam, width, height,
                    jitter_enabled=True, tri_mask=None, single_sided=None,
                    chunk: int = 64) -> VisibilityBuffer:
    """Convenience: world verts + index triple + camera → visibility buffer."""
    vp = jnp.matmul(cam.proj, cam.view, precision=HIGHEST)
    jit = cam.jitter if jitter_enabled else None
    clip = transform_to_clip(world_pos, vp, jit)
    tris = clip_triangles(clip, i0, i1, i2, width, height, tri_mask,
                          single_sided)
    return rasterize(tris, width, height, chunk=chunk)
