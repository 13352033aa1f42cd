"""Binned tile rasterizer (ops/raster_tile.py) against the reference scan
(ops/raster.rasterize): the Pallas kernel in interpret mode on the CPU,
the XLA binning, and the resolve stage."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.ops import raster, raster_tile
from hybridrenderer.ops.image import tri_boundary_mask
from hybridrenderer.scene import scene as scenes

SCENES = {
    "cube": (scenes.cube_scene, dict(distance=7.0, pitch=0.45, yaw=0.6,
                                     focal_point=(0, 0.7, 0))),
    "cornell": (scenes.cornell_scene, dict(distance=13.0, pitch=0.0,
                                           yaw=0.0, focal_point=(0, 2.5, 0))),
    "cutout": (scenes.cutout_scene, dict(distance=9.0, pitch=0.35, yaw=0.4,
                                         focal_point=(0, 1.2, 0))),
    "stress": (lambda: scenes.stress_scene(num_objects=8, seed=3),
               dict(distance=18.0, pitch=0.5, yaw=0.8,
                    focal_point=(0, 2.0, 0))),
}
_DATA = {}


def _tris(name, W, H, cull="back", jitter=False):
    if name not in _DATA:
        _DATA[name] = SCENES[name][0]().build()
    data = _DATA[name]
    cam = OrbitCamera(width=W, height=H, **SCENES[name][1]).step(
        taa_enabled=jitter)
    vp = jnp.asarray(cam.proj) @ jnp.asarray(cam.view)
    clip = raster.transform_to_clip(
        data.vertices.world_position, vp,
        jnp.asarray(cam.jitter) if jitter else None)
    return raster.clip_triangles(
        clip, data.triangles.i0, data.triangles.i1, data.triangles.i2, W, H,
        single_sided=data.triangles.single_sided if cull == "back" else None)


def _assert_matches(ref, out):
    """tri_id equal off a 1-px dilation of the reference's triangle
    boundaries (winner flips from float order live only there); depth
    and barycentrics within f32 round-off where the winners agree: the
    kernel and the scan may contract products into FMAs differently, and
    an edge function's constant term is O(x·y) px², so one ulp of it is
    ~1e-4 of a few-px² triangle's area — up to ~1e-3 in barycentrics."""
    a, b = np.asarray(ref.tri_id), np.asarray(out.tri_id)
    off_edge = ~tri_boundary_mask(a, dilate=1)
    np.testing.assert_array_equal(b[off_edge], a[off_edge])
    same = a == b
    assert same.mean() > 0.98
    np.testing.assert_allclose(np.asarray(out.depth)[same],
                               np.asarray(ref.depth)[same],
                               rtol=1e-4, atol=1e-5)
    for f in ("bary1", "bary2"):
        np.testing.assert_allclose(np.asarray(getattr(out, f))[same],
                                   np.asarray(getattr(ref, f))[same],
                                   atol=2e-3)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("cull", ["back", "none"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tile_kernel_matches_reference(scene, cull, jitter):
    W, H = 64, 48
    tris = _tris(scene, W, H, cull, jitter)
    ref = raster.rasterize(tris, W, H)
    out = raster_tile.rasterize(tris, W, H, interpret=True)
    assert (np.asarray(ref.tri_id) >= 0).any()
    _assert_matches(ref, out)


@pytest.mark.parametrize("W,H", [(37, 29), (50, 17), (16, 16)])
def test_sizes_that_are_not_a_tile_multiple(W, H):
    tris = _tris("cube", W, H)
    ref = raster.rasterize(tris, W, H)
    out = raster_tile.rasterize(tris, W, H, interpret=True)
    assert out.tri_id.shape == (H, W)
    _assert_matches(ref, out)


def test_row_offset_renders_the_matching_rows():
    """A band of rows starting at row0 (a row shard of the frame) equals
    those rows of the full-screen render bit for bit."""
    W, H = 48, 64
    tris = _tris("cornell", W, H)
    full = raster_tile.rasterize(tris, W, H, interpret=True)
    band = raster_tile.rasterize(tris, W, 16, row0=32, interpret=True)
    for f in ("tri_id", "depth", "bary1", "bary2"):
        np.testing.assert_array_equal(np.asarray(getattr(band, f)),
                                      np.asarray(getattr(full, f))[32:48])


def test_binning_covers_every_pixel_candidate():
    """Every (pixel, candidate) coverage of the reference lies in a tile
    or row group the kernel walks for that pixel."""
    W, H = 64, 48
    tris = _tris("stress", W, H)
    rec, bbox, live = raster_tile.pack_records(tris)
    rec, starts, counts, entries, dropped = raster_tile.bin_entries(
        rec, bbox, live, W, H)
    assert int(dropped) == 0
    ntx = -(-W // raster_tile.TILE_W)
    ntiles = ntx * -(-H // raster_tile.TILE_H)
    starts, counts, entries = map(np.asarray, (starts, counts, entries))
    ref = np.asarray(raster.rasterize(tris, W, H).tri_id)
    rec = np.asarray(rec)
    tri_id = np.asarray(tris.tri_id)
    for y in range(0, H, 5):
        for x in range(0, W, 5):
            if ref[y, x] < 0:
                continue
            ty, tx = y // raster_tile.TILE_H, x // raster_tile.TILE_W
            t = ty * ntx + tx
            cands = list(entries[starts[t]:starts[t] + counts[t]])
            g = ntiles + ty
            cands += [c for c in entries[starts[g]:starts[g] + counts[g]]
                      if rec[c, raster_tile._R_TX0] <= tx
                      <= rec[c, raster_tile._R_TX1]]
            assert ref[y, x] in tri_id[cands]


def test_groups_keep_candidate_order():
    """Inside each group candidates ascend, so the kernel's strict '>'
    keeps the lowest index among equal depths, as the reference does."""
    W, H = 64, 48
    tris = _tris("stress", W, H)
    rec, bbox, live = raster_tile.pack_records(tris)
    _, starts, counts, entries, _ = raster_tile.bin_entries(
        rec, bbox, live, W, H)
    starts, counts, entries = map(np.asarray, (starts, counts, entries))
    for s, n in zip(starts, counts):
        grp = entries[s:s + n]
        assert (np.diff(grp) > 0).all()


def test_row_cap_counts_dropped_wide_candidates():
    W, H = 64, 48
    tris = _tris("cube", W, H, cull="none")
    rec, bbox, live = raster_tile.pack_records(tris)
    *_, dropped_all = raster_tile.bin_entries(rec, bbox, live, W, H)
    *_, dropped = raster_tile.bin_entries(rec, bbox, live, W, H,
                                          max_span=1, cap_rows=1)
    assert int(dropped_all) == 0
    assert int(dropped) > 0


def test_dead_candidates_never_cover():
    """Invalid / zero-area candidates pack to an edge form that is
    negative everywhere."""
    W, H = 32, 32
    tris = _tris("cube", W, H)
    tris = dataclasses.replace(tris, valid=jnp.zeros_like(tris.valid))
    out = raster_tile.rasterize(tris, W, H, interpret=True)
    assert (np.asarray(out.tri_id) == -1).all()
    assert (np.asarray(out.depth) == 0.0).all()


def test_equal_depth_tie_goes_to_lowest_index():
    """Two identical triangles: the reference scan and the kernel both
    keep the first."""
    sxy = jnp.asarray([[[2.0, 2.0], [30.0, 4.0], [6.0, 28.0]]] * 2,
                      jnp.float32)
    T2 = 2
    tris = raster.ClippedTriangles(
        sxy=sxy, z=jnp.full((T2, 3), 0.5, jnp.float32),
        inv_w=jnp.ones((T2, 3), jnp.float32),
        bary=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (T2, 3, 3)),
        tri_id=jnp.asarray([7, 9], jnp.int32),
        valid=jnp.ones((T2,), bool))
    ref = raster.rasterize(tris, 32, 32)
    out = raster_tile.rasterize(tris, 32, 32, interpret=True)
    covered = np.asarray(ref.tri_id) >= 0
    assert covered.any()
    assert (np.asarray(out.tri_id)[covered] == 7).all()
    np.testing.assert_array_equal(np.asarray(out.tri_id),
                                  np.asarray(ref.tri_id))
