"""Binned tile rasterizer: XLA binning + a Pallas kernel through Triton.

Same contract as ``ops/raster.rasterize`` (a VisibilityBuffer of
tri_id, perspective-correct original barycentrics and reversed-Z depth),
in three stages:

1. **Pack + bin (XLA).** Every post-clip candidate becomes a 16-float
   record: its three sign-corrected edge forms, 1/area, the three vertex
   depths and its tile-column extent. Candidates whose screen box spans
   at most ``MAX_SPAN`` tiles get one entry per covered tile; wider
   ones (and the second clip slot) get one entry per covered tile ROW.
   One stable sort groups the entries by tile, then by row, keeping
   candidate order inside each group.
2. **Tile kernel (Pallas, Triton).** One program per TILE_H x TILE_W
   tile walks its tile's entries and then its row's entries (skipping
   records whose tile-column extent misses the tile), evaluates coverage
   and depth on the tile's pixels, and keeps the nearest (reversed-Z
   max) candidate with a strict ``>``, so ties go to the lowest
   candidate index exactly as in the reference scan.
3. **Resolve (XLA).** The winner's barycentrics are recomputed from its
   ClippedTriangles row with the reference's own per-candidate formulas.

``row0`` offsets the pixel rows, so a row-sharded frame rasterizes its
own rows of the full-screen candidate set (parallel/sharded.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .raster import (AREA_EPS, ClippedTriangles, VisibilityBuffer,
                     _edge_coeffs, candidate_barycentrics)

TILE_H = 16
TILE_W = 16
MAX_SPAN = 8       # tiles a candidate may cover and still get tile entries
REC = 16           # record width (f32)
_R_IA = 9          # 1/area
_R_Z = 10          # vertex depths at 10, 11, 12
_R_TX0 = 13        # first / last covered tile column
_R_TX1 = 14


def pack_records(tris: ClippedTriangles):
    """ClippedTriangles → (records (T2, 16), screen bbox (T2, 4), live)."""
    p0, p1, p2 = tris.sxy[:, 0], tris.sxy[:, 1], tris.sxy[:, 2]
    a0, b0, g0 = _edge_coeffs(p1, p2)
    a1, b1, g1 = _edge_coeffs(p2, p0)
    a2, b2, g2 = _edge_coeffs(p0, p1)
    area2 = g0 + a0 * p0[:, 0] + b0 * p0[:, 1]
    sgn = jnp.where(area2 < 0, -1.0, 1.0)
    area2 = jnp.abs(area2)
    live = tris.valid & (area2 > AREA_EPS)
    # negation is exact, so sgn·(a·x + b·y + g) == (sgn·a)·x + (sgn·b)·y
    # + sgn·g bit for bit: the kernel evaluates the reference's forms
    edges = jnp.stack([a0, b0, g0, a1, b1, g1, a2, b2, g2], 1) * sgn[:, None]
    never = jnp.zeros((9,), jnp.float32).at[2].set(-1.0)
    edges = jnp.where(live[:, None], edges, never)
    inv_area = 1.0 / jnp.maximum(area2, AREA_EPS)
    T2 = tris.tri_id.shape[0]
    rec = jnp.concatenate([edges, inv_area[:, None], tris.z,
                           jnp.zeros((T2, 3), jnp.float32)], axis=1)
    xs, ys = tris.sxy[..., 0], tris.sxy[..., 1]
    bbox = jnp.stack([xs.min(1), xs.max(1), ys.min(1), ys.max(1)], -1)
    return rec, bbox, live


def bin_entries(rec, bbox, live, width: int, height: int, row0=0,
                max_span: int = MAX_SPAN, cap_rows: int = None):
    """Group candidates by screen tile (and wide ones by tile row).

    Returns (records with tile-column extents, starts, counts, entries,
    n_dropped): group g's candidate ids are entries[starts[g]:][:counts[g]],
    groups [0, ntiles) are tiles and [ntiles, ntiles + nty) tile rows.
    ``cap_rows`` bounds how many wide candidates get row entries (static
    shapes); ``n_dropped`` counts the ones beyond it, which are lost."""
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    ntiles = ntx * nty
    T2 = rec.shape[0]
    half = T2 // 2
    if cap_rows is None:
        cap_rows = T2 if T2 <= 16384 else max(16384, T2 // 8)
    cap_rows = min(cap_rows, T2)
    row0f = jnp.asarray(row0, jnp.float32)
    y0 = bbox[:, 2] - row0f
    y1 = bbox[:, 3] - row0f
    onscreen = live & (bbox[:, 1] >= 0) & (bbox[:, 0] < width) \
        & (y1 >= 0) & (y0 < height)
    tx0 = jnp.clip(jnp.floor(bbox[:, 0] / TILE_W), 0, ntx - 1).astype(
        jnp.int32)
    tx1 = jnp.clip(jnp.floor(bbox[:, 1] / TILE_W), 0, ntx - 1).astype(
        jnp.int32)
    ty0 = jnp.clip(jnp.floor(y0 / TILE_H), 0, nty - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(y1 / TILE_H), 0, nty - 1).astype(jnp.int32)
    rec = rec.at[:, _R_TX0].set(tx0.astype(jnp.float32))
    rec = rec.at[:, _R_TX1].set(tx1.astype(jnp.float32))
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    # the second clip slot (near-plane crossers, rare) rides the row path
    # so the tile entries cover only the first half of the candidates
    tile_cls = onscreen & (span_w * span_h <= max_span) \
        & (jnp.arange(T2) < half)
    wide = onscreen & ~tile_cls
    dead = ntiles + nty

    k = jnp.arange(max_span, dtype=jnp.int32)[None, :]
    sw = span_w[:half, None]
    key_t = jnp.where((k < (sw * span_h[:half, None])) & tile_cls[:half, None],
                      (ty0[:half, None] + k // sw) * ntx
                      + tx0[:half, None] + k % sw, dead)
    cand_t = jnp.broadcast_to(jnp.arange(half, dtype=jnp.int32)[:, None],
                              key_t.shape)

    rank = jnp.cumsum(wide.astype(jnp.int32)) - 1
    slot = jnp.where(wide & (rank < cap_rows), rank, cap_rows)
    wide_ids = jnp.full((cap_rows,), T2, jnp.int32).at[slot].set(
        jnp.arange(T2, dtype=jnp.int32), mode="drop")
    alive = wide_ids < T2
    wide_ids = jnp.minimum(wide_ids, T2 - 1)
    kr = jnp.arange(nty, dtype=jnp.int32)[None, :]
    key_r = jnp.where((kr < span_h[wide_ids][:, None]) & alive[:, None],
                      ntiles + ty0[wide_ids][:, None] + kr, dead)
    cand_r = jnp.broadcast_to(wide_ids[:, None], key_r.shape)

    keys = jnp.concatenate([key_t.reshape(-1), key_r.reshape(-1)])
    cands = jnp.concatenate([cand_t.reshape(-1), cand_r.reshape(-1)])
    keys, entries = jax.lax.sort((keys, cands), num_keys=1, is_stable=True)
    bounds = jnp.searchsorted(
        keys, jnp.arange(dead + 1, dtype=keys.dtype)).astype(jnp.int32)
    n_dropped = jnp.sum(wide.astype(jnp.int32)) \
        - jnp.sum(alive.astype(jnp.int32))
    return rec, bounds[:-1], bounds[1:] - bounds[:-1], entries, n_dropped


def _tile_kernel(ntx, ntiles, row0_ref, starts_ref, counts_ref, ent_ref,
                 rec_ref, z_ref, win_ref):
    t = pl.program_id(0)
    ty = t // ntx
    tx = t - ty * ntx
    p = jax.lax.iota(jnp.int32, TILE_H * TILE_W)
    px = (tx * TILE_W + p % TILE_W).astype(jnp.float32) + 0.5
    py = (row0_ref[0] + ty * TILE_H + p // TILE_W).astype(jnp.float32) + 0.5

    def visit(c, carry):
        zb, wb = carry
        r = [rec_ref[c, j] for j in range(_R_Z + 3)]
        e0 = r[0] * px + r[1] * py + r[2]
        e1 = r[3] * px + r[4] * py + r[5]
        e2 = r[6] * px + r[7] * py + r[8]
        ia = r[_R_IA]
        z = (e0 * ia) * r[_R_Z] + (e1 * ia) * r[_R_Z + 1] \
            + (e2 * ia) * r[_R_Z + 2]
        take = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0) \
            & (z <= 1.0) & (z > zb)
        return jnp.where(take, z, zb), jnp.where(take, c, wb)

    def tile_entry(i, carry):
        return visit(ent_ref[i], carry)

    def row_entry(i, carry):
        c = ent_ref[i]
        inside = (tx >= rec_ref[c, _R_TX0].astype(jnp.int32)) \
            & (tx <= rec_ref[c, _R_TX1].astype(jnp.int32))
        return jax.lax.cond(inside, functools.partial(visit, c),
                            lambda cr: cr, carry)

    carry = (jnp.zeros(p.shape, jnp.float32),
             jnp.full(p.shape, -1, jnp.int32))
    s = starts_ref[t]
    carry = jax.lax.fori_loop(s, s + counts_ref[t], tile_entry, carry)
    s = starts_ref[ntiles + ty]
    carry = jax.lax.fori_loop(s, s + counts_ref[ntiles + ty], row_entry,
                              carry)
    z_ref[...] = carry[0]
    win_ref[...] = carry[1]


def raster_tiles(rec, starts, counts, entries, width: int, height: int,
                 row0=0, interpret: bool = False):
    """Run the tile kernel → (depth (H, W), winning candidate (H, W))."""
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    ntiles = ntx * nty
    P = TILE_H * TILE_W
    out_spec = pl.BlockSpec((None, P), lambda t: (t, 0))
    z, win = pl.pallas_call(
        functools.partial(_tile_kernel, ntx, ntiles),
        grid=(ntiles,),
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((ntiles, P), jnp.float32),
                   jax.ShapeDtypeStruct((ntiles, P), jnp.int32)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raster_tiles",
    )(jnp.asarray(row0, jnp.int32).reshape(1), starts, counts, entries, rec)

    def image(x):
        x = x.reshape(nty, ntx, TILE_H, TILE_W).transpose(0, 2, 1, 3)
        return x.reshape(nty * TILE_H, ntx * TILE_W)[:height, :width]

    return image(z), image(win)


def resolve(tris: ClippedTriangles, depth, win, width: int, height: int,
            row0=0) -> VisibilityBuffer:
    """Winner ids → VisibilityBuffer, barycentrics recomputed with the
    reference's per-candidate formulas."""
    bg = win < 0
    w = jnp.maximum(win, 0)
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.arange(height, dtype=jnp.int32)
          + jnp.asarray(row0, jnp.int32)).astype(jnp.float32)[:, None] + 0.5
    b1, b2 = candidate_barycentrics(tris.sxy[w], tris.inv_w[w],
                                    tris.bary[w], px, py)
    return VisibilityBuffer(
        tri_id=jnp.where(bg, -1, tris.tri_id[w]),
        bary1=jnp.where(bg, 0.0, b1),
        bary2=jnp.where(bg, 0.0, b2),
        depth=jnp.where(bg, 0.0, depth))


def rasterize(tris: ClippedTriangles, width: int, height: int, row0=0,
              interpret: bool = False, with_stats: bool = False):
    """pack → bin → tile kernel → resolve. ``height`` rows starting at
    pixel row ``row0`` of a ``width``-wide screen. With ``with_stats``
    also returns {"entries", "n_dropped"}."""
    rec, bbox, live = pack_records(tris)
    rec, starts, counts, entries, n_dropped = bin_entries(
        rec, bbox, live, width, height, row0)
    depth, win = raster_tiles(rec, starts, counts, entries, width, height,
                              row0, interpret=interpret)
    vis = resolve(tris, depth, win, width, height, row0)
    if with_stats:
        return vis, {"entries": entries.shape[0], "n_dropped": n_dropped}
    return vis
