"""Binned-SAH BVH builder (host, vectorized numpy, level-synchronous).

Replaces the Morton/Karras LBVH (ops/bvh.py) as the quality build: the
reference requests PREFER_FAST_TRACE acceleration structures
(Scene.cpp:397, Model.cpp:150), i.e. the driver's SAH builder; the LBVH
is the PREFER_FAST_BUILD analog and remains for dynamic rebuild paths.

Output uses the exact node convention of ops/bvh.BVH so the node
packing (ops/trace_cuda.pack_nodes) and every traversal work unchanged:
  internal nodes 0 .. T-2, leaf k = node (T-1)+k holding the k-th
  triangle of the builder's final (in-order) triangle order, and every
  subtree covers a contiguous range of that order.

Algorithm: classic top-down binned SAH (Wald 2007), all nodes of one
depth processed together with segmented numpy ops:
  * per node: centroid bounds → 16 bins on the largest centroid axis,
  * per-bin triangle AABBs/counts via np.minimum.at / np.add.at,
  * SAH sweep picks the cheapest split; median fallback when binning
    degenerates; nodes split down to single-triangle leaves.
"""
from __future__ import annotations

import numpy as np

from .bvh import BVH

NBINS = 16
MAX_DEPTH = 64


def _aabb_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def build_sah(tri_v0, tri_v1, tri_v2) -> BVH:
    """World triangles → binned-SAH BVH (same struct as ops/bvh.BVH)."""
    import jax.numpy as jnp

    v0 = np.asarray(tri_v0, np.float32)
    v1 = np.asarray(tri_v1, np.float32)
    v2 = np.asarray(tri_v2, np.float32)
    T = v0.shape[0]
    if T <= 2:
        from .bvh import build_bvh

        return build_bvh(tri_v0, tri_v1, tri_v2)

    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    cen = (tlo + thi) * 0.5

    order = np.arange(T, dtype=np.int64)     # position → original tri
    n_int = T - 1
    N = 2 * T - 1
    node_min = np.zeros((N, 3), np.float32)
    node_max = np.zeros((N, 3), np.float32)
    left = np.full(N, -1, np.int32)
    right = np.full(N, -1, np.int32)

    # frontier: per active internal node its [start, end) position range
    f_node = np.array([0], np.int64)
    f_start = np.array([0], np.int64)
    f_end = np.array([T], np.int64)
    next_internal = 1
    # leaf bookkeeping: node ids are assigned AFTER ordering settles, so
    # track, per final position, nothing — leaves are implicit.
    node_min[0] = tlo.min(0)
    node_max[0] = thi.max(0)

    for _depth in range(MAX_DEPTH):
        if len(f_node) == 0:
            break
        counts = f_end - f_start
        nseg = len(f_node)
        # per-position segment rank (vectorized range construction)
        seg_of = np.repeat(np.arange(nseg, dtype=np.int64), counts)
        tot = int(counts.sum())
        heads = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.repeat(f_start, counts) \
            + (np.arange(tot, dtype=np.int64) - np.repeat(heads, counts))
        tri_at = order[pos]
        c = cen[tri_at]

        # centroid bounds per segment
        cmin = np.full((nseg, 3), np.inf, np.float32)
        cmax = np.full((nseg, 3), -np.inf, np.float32)
        np.minimum.at(cmin, seg_of, c)
        np.maximum.at(cmax, seg_of, c)
        ext = cmax - cmin
        axis = np.argmax(ext, axis=1)
        ax_ext = np.maximum(ext[np.arange(nseg), axis], 1e-12)

        # bin ids
        cax = c[np.arange(len(c)), axis[seg_of]]
        rel = (cax - cmin[seg_of, axis[seg_of]]) / ax_ext[seg_of]
        b = np.clip((rel * NBINS).astype(np.int64), 0, NBINS - 1)
        key = seg_of * NBINS + b

        bin_cnt = np.zeros(nseg * NBINS, np.int64)
        np.add.at(bin_cnt, key, 1)
        bin_lo = np.full((nseg * NBINS, 3), np.inf, np.float32)
        bin_hi = np.full((nseg * NBINS, 3), -np.inf, np.float32)
        np.minimum.at(bin_lo, key, tlo[tri_at])
        np.maximum.at(bin_hi, key, thi[tri_at])
        bin_cnt = bin_cnt.reshape(nseg, NBINS)
        bin_lo = bin_lo.reshape(nseg, NBINS, 3)
        bin_hi = bin_hi.reshape(nseg, NBINS, 3)

        # prefix/suffix sweeps
        llo = np.minimum.accumulate(bin_lo, axis=1)
        lhi = np.maximum.accumulate(bin_hi, axis=1)
        rlo = np.minimum.accumulate(bin_lo[:, ::-1], axis=1)[:, ::-1]
        rhi = np.maximum.accumulate(bin_hi[:, ::-1], axis=1)[:, ::-1]
        lcnt = np.cumsum(bin_cnt, axis=1)
        rcnt = counts[:, None] - lcnt
        # split after bin i (i in 0..NBINS-2)
        cost = _aabb_area(llo[:, :-1], lhi[:, :-1]) * lcnt[:, :-1] \
            + _aabb_area(rlo[:, 1:], rhi[:, 1:]) * np.maximum(rcnt[:, :-1], 0)
        cost = np.where((lcnt[:, :-1] == 0) | (rcnt[:, :-1] == 0),
                        np.inf, cost)
        best = np.argmin(cost, axis=1)
        best_ok = np.isfinite(cost[np.arange(nseg), best])

        # goes_right per position; median fallback for degenerate bins
        go_right = b > best[seg_of]
        # median fallback: split segment at count//2 by bin-then-pos order
        need_fb = ~best_ok
        if need_fb.any():
            # per-segment rank by axis value; send the top half right —
            # stable and always balanced
            o2 = np.lexsort((cax, seg_of))
            rank_in_seg = np.empty(len(o2), np.int64)
            seg_sorted = seg_of[o2]
            first = np.ones(len(o2), bool)
            first[1:] = seg_sorted[1:] != seg_sorted[:-1]
            gidx = np.arange(len(o2))
            seg_start_idx = np.maximum.accumulate(np.where(first, gidx, 0))
            rank_in_seg[o2] = gidx - seg_start_idx
            half = (counts // 2)[seg_of]
            go_right = np.where(need_fb[seg_of], rank_in_seg >= half,
                                go_right)

        # stable partition within segments: new order
        part_key = seg_of * 2 + go_right.astype(np.int64)
        new_of_seg = np.argsort(part_key, kind="stable")
        order[pos] = tri_at[new_of_seg]
        nleft = np.zeros(nseg, np.int64)
        np.add.at(nleft, seg_of, (~go_right).astype(np.int64))
        mid = f_start + nleft

        # child AABBs (true triangle bounds per side)
        side_lo = np.full((nseg * 2, 3), np.inf, np.float32)
        side_hi = np.full((nseg * 2, 3), -np.inf, np.float32)
        skey = seg_of * 2 + go_right.astype(np.int64)
        np.minimum.at(side_lo, skey, tlo[tri_at])
        np.maximum.at(side_hi, skey, thi[tri_at])

        # allocate children: internal if count > 1 else leaf
        lcounts = nleft
        rcounts = counts - nleft
        new_f_node, new_f_start, new_f_end = [], [], []
        for side, scounts, s0, s1 in ((0, lcounts, f_start, mid),
                                      (1, rcounts, mid, f_end)):
            is_int = scounts > 1
            n_new = int(is_int.sum())
            ids = np.full(nseg, -1, np.int64)
            ids[is_int] = next_internal + np.arange(n_new)
            next_internal += n_new
            # leaves: child id = (T-1) + final position (start of range)
            leaf_ids = (T - 1) + s0
            child = np.where(is_int, ids, leaf_ids).astype(np.int32)
            if side == 0:
                left[f_node] = child
            else:
                right[f_node] = child
            node_min[ids[is_int]] = side_lo.reshape(nseg, 2, 3)[is_int, side]
            node_max[ids[is_int]] = side_hi.reshape(nseg, 2, 3)[is_int, side]
            new_f_node.append(ids[is_int])
            new_f_start.append(s0[is_int])
            new_f_end.append(s1[is_int])

        f_node = np.concatenate(new_f_node)
        f_start = np.concatenate(new_f_start)
        f_end = np.concatenate(new_f_end)
        if len(f_node) and _depth == MAX_DEPTH - 1:
            raise ValueError("SAH build exceeded MAX_DEPTH")

    assert next_internal == n_int, (next_internal, n_int)

    # leaf nodes
    node_min[T - 1:] = tlo[order]
    node_max[T - 1:] = thi[order]
    tri = np.concatenate([np.full(T - 1, -1, np.int64), order]) \
        .astype(np.int32)
    return BVH(node_min=jnp.asarray(node_min),
               node_max=jnp.asarray(node_max),
               left=jnp.asarray(left), right=jnp.asarray(right),
               tri=jnp.asarray(tri), num_tris=jnp.int32(T))
