"""LBVH build — the BLAS/TLAS replacement.

The reference builds per-mesh BLASes + a TLAS through Vulkan acceleration
structures (Model.cpp:114-186, Scene.cpp:323-440). Here we build one
*linear BVH* over the world-space triangle soup: Morton codes of triangle
centroids, a radix sort, a Karras-2012 binary radix tree (every internal
node computed independently — fully parallel, no sequential insertion),
and level-free iterative AABB propagation. Everything is jnp, so the
build itself runs on-device and re-runs cheaply on scene changes.

Node indexing for T triangles:
  internal nodes: 0 .. T-2
  leaves:         T-1 .. 2T-2  (leaf k = node (T-1)+k, holds sorted tri k)
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVH:
    node_min: Any   # (2T-1, 3)
    node_max: Any   # (2T-1, 3)
    left: Any       # (2T-1,) i32 child node id (undefined for leaves)
    right: Any      # (2T-1,) i32
    tri: Any        # (2T-1,) i32 original triangle id for leaves, -1 internal
    num_tris: Any   # () i32

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def morton_codes(centroids, scene_min, scene_max):
    """30-bit Morton codes of centroids normalized to the scene AABB."""
    extent = jnp.maximum(scene_max - scene_min, 1e-9)
    q = jnp.clip((centroids - scene_min) / extent, 0.0, 1.0 - 1e-7)
    xyz = (q * 1024.0).astype(jnp.uint32)  # 10 bits per axis

    def expand_bits(v):
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    return (expand_bits(xyz[:, 0]) * 4 + expand_bits(xyz[:, 1]) * 2
            + expand_bits(xyz[:, 2]))


def _clz32(x):
    """Count leading zeros of uint32 (branchless bit-length)."""
    x = x.astype(jnp.uint32)
    bl = jnp.zeros(x.shape, jnp.int32)
    for shift in (16, 8, 4, 2, 1):
        mask = x >= (jnp.uint32(1) << shift)
        bl = jnp.where(mask, bl + shift, bl)
        x = jnp.where(mask, x >> shift, x)
    bl = bl + x.astype(jnp.int32)  # remaining 0/1 bit
    return 32 - bl


def _delta(codes, i, j, T):
    """Longest-common-prefix metric with index tie-break (Karras §4)."""
    valid = (j >= 0) & (j < T)
    jc = jnp.clip(j, 0, T - 1)
    ci = codes[i]
    cj = codes[jc]
    same = ci == cj
    d_code = _clz32(ci ^ cj)
    d_idx = 32 + _clz32((i.astype(jnp.uint32) ^ jc.astype(jnp.uint32)))
    d = jnp.where(same, d_idx, d_code)
    return jnp.where(valid, d, -1)


def build_radix_tree(codes):
    """Karras binary radix tree: per-internal-node range + split, all
    vectorized (no data-dependent loops beyond fixed 32-step searches)."""
    T = codes.shape[0]
    i = jnp.arange(T - 1, dtype=jnp.int32)

    d = jnp.sign(_delta(codes, i, i + 1, T) - _delta(codes, i, i - 1, T)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = _delta(codes, i, i - d, T)

    # The three fixed 32-step searches run as fori_loops, not unrolled
    # Python loops: unrolled they put ~300 full-array gather steps in the
    # graph and compile time grows with them; looped, the graph is tiny
    # and runtime is unchanged (the build is cheap next to a frame).

    # exponential search for range upper bound (covers ranges up to 2^32)
    def exp_body(_k, lmax):
        probe = _delta(codes, i, i + lmax * d, T)
        return jnp.where(probe > delta_min, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, 32, exp_body, jnp.full_like(i, 2))

    # binary search for exact length l
    def len_body(_k, carry):
        l, t = carry
        probe = _delta(codes, i, i + (l + t) * d, T)
        return jnp.where((t > 0) & (probe > delta_min), l + t, l), t // 2

    l, _ = jax.lax.fori_loop(0, 32, len_body,
                             (jnp.zeros_like(i), lmax // 2))

    j = i + l * d
    delta_node = _delta(codes, i, j, T)

    # binary search for split point
    def split_body(_k, carry):
        s, div = carry
        t = (l + div - 1) // div
        probe = _delta(codes, i, i + (s + t) * d, T)
        s = jnp.where((t > 0) & (probe > delta_node), s + t, s)
        # cap before doubling: avoids int32 overflow; t==0 there anyway
        return s, jnp.minimum(div, 1 << 29) * 2

    s, _ = jax.lax.fori_loop(0, 32, split_body,
                             (jnp.zeros_like(i), jnp.int32(2)))

    gamma = i + s * d + jnp.minimum(d, 0)
    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    # child is a leaf when the range collapses
    left = jnp.where(lo == gamma, (T - 1) + gamma, gamma)
    right = jnp.where(hi == gamma + 1, (T - 1) + gamma + 1, gamma + 1)
    return left, right


@functools.partial(jax.jit, static_argnames=("max_depth_iters",))
def build_bvh(v0, v1, v2, max_depth_iters: int = 64) -> BVH:
    """World-space triangles → LBVH. All-jnp and jitted: the device build
    used when the native host builder is unavailable."""
    T = v0.shape[0]
    if T == 0:
        z3 = jnp.zeros((1, 3), jnp.float32)
        zi = jnp.zeros((1,), jnp.int32)
        return BVH(z3, z3, zi, zi, jnp.full((1,), -1, jnp.int32),
                   jnp.int32(0))
    if T == 1:
        tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
        tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
        return BVH(tmin, tmax, jnp.full((1,), -1, jnp.int32),
                   jnp.full((1,), -1, jnp.int32),
                   jnp.zeros((1,), jnp.int32), jnp.int32(1))

    centroids = (v0 + v1 + v2) / 3.0
    scene_min = jnp.min(jnp.minimum(jnp.minimum(v0, v1), v2), axis=0)
    scene_max = jnp.max(jnp.maximum(jnp.maximum(v0, v1), v2), axis=0)

    codes = morton_codes(centroids, scene_min, scene_max)
    order = jnp.argsort(codes).astype(jnp.int32)
    codes = codes[order]

    left, right = build_radix_tree(codes)

    N = 2 * T - 1
    tri = jnp.concatenate([jnp.full((T - 1,), -1, jnp.int32), order])
    left_full = jnp.concatenate([left, jnp.full((T,), -1, jnp.int32)])
    right_full = jnp.concatenate([right, jnp.full((T,), -1, jnp.int32)])

    # leaf AABBs (sorted order), internal zeroed then propagated
    tv0, tv1, tv2 = v0[order], v1[order], v2[order]
    leaf_min = jnp.minimum(jnp.minimum(tv0, tv1), tv2)
    leaf_max = jnp.maximum(jnp.maximum(tv0, tv1), tv2)
    node_min = jnp.concatenate([jnp.full((T - 1, 3), jnp.inf), leaf_min])
    node_max = jnp.concatenate([jnp.full((T - 1, 3), -jnp.inf), leaf_max])

    # iterative bottom-up union: after k iterations all nodes whose height
    # ≤ k are correct; LBVH height is O(log T) thanks to index tie-breaks.
    def prop(carry, _):
        nmin, nmax = carry
        lmin = nmin[left_full[: T - 1]]
        lmax_ = nmax[left_full[: T - 1]]
        rmin = nmin[right_full[: T - 1]]
        rmax = nmax[right_full[: T - 1]]
        new_min = nmin.at[: T - 1].set(jnp.minimum(lmin, rmin))
        new_max = nmax.at[: T - 1].set(jnp.maximum(lmax_, rmax))
        return (new_min, new_max), None

    # T is a static Python int — keep this computation host-side so the
    # whole builder is jittable (math, not jnp: jnp.log2 would trace)
    iters = min(max_depth_iters, max(2, math.ceil(math.log2(T)) * 2 + 8))
    (node_min, node_max), _ = jax.lax.scan(prop, (node_min, node_max),
                                           None, length=iters)
    return BVH(node_min.astype(jnp.float32), node_max.astype(jnp.float32),
               left_full, right_full, tri, jnp.int32(T))


# --- native host builder (native/bvh_builder.cpp) -----------------------
def _load_native():
    from .. import native

    lib = native.load("bvh")
    if lib is not None:
        lib.hr_build_lbvh.restype = ctypes.c_int
    return lib


def _build_native(v0, v1, v2, fn_name: str) -> "BVH | None":
    import numpy as np

    lib = _load_native()
    if lib is None or not hasattr(lib, fn_name):
        return None
    a0 = np.ascontiguousarray(np.asarray(v0, np.float32))
    a1 = np.ascontiguousarray(np.asarray(v1, np.float32))
    a2 = np.ascontiguousarray(np.asarray(v2, np.float32))
    T = a0.shape[0]
    if T == 0:
        z3 = jnp.zeros((1, 3), jnp.float32)
        zi = jnp.zeros((1,), jnp.int32)
        return BVH(z3, z3, zi, zi, jnp.full((1,), -1, jnp.int32),
                   jnp.int32(0))
    N = 2 * T - 1
    nmin = np.empty((N, 3), np.float32)
    nmax = np.empty((N, 3), np.float32)
    left = np.empty((N,), np.int32)
    right = np.empty((N,), np.int32)
    tri = np.empty((N,), np.int32)

    def p(x, t):
        return x.ctypes.data_as(ctypes.POINTER(t))

    rc = getattr(lib, fn_name)(
        p(a0, ctypes.c_float), p(a1, ctypes.c_float), p(a2, ctypes.c_float),
        ctypes.c_longlong(T), p(nmin, ctypes.c_float),
        p(nmax, ctypes.c_float), p(left, ctypes.c_int),
        p(right, ctypes.c_int), p(tri, ctypes.c_int))
    if rc != 0:
        return None
    return BVH(jnp.asarray(nmin), jnp.asarray(nmax), jnp.asarray(left),
               jnp.asarray(right), jnp.asarray(tri), jnp.int32(T))


def build_bvh_native(v0, v1, v2) -> "BVH | None":
    """Host-side LBVH build via the C++ builder (tree-identical to the
    jitted build_bvh; see native/bvh_builder.cpp). Returns None when the
    native library is unavailable. Preferred at scene-build time: the
    device build costs an XLA compile per new triangle count; this is
    milliseconds."""
    return _build_native(v0, v1, v2, "hr_build_lbvh")


def build_sah_native(v0, v1, v2) -> "BVH | None":
    """Host-side binned-SAH build (native/bvh_builder.cpp
    hr_build_sah) — the PREFER_FAST_TRACE driver-build analog
    (Scene.cpp:397): fewer traversal steps than the LBVH;
    topology-frozen refits (refit_bvh) work on its trees unchanged."""
    return _build_native(v0, v1, v2, "hr_build_sah")


def build_bvh_host(v0, v1, v2, builder: str = "lbvh") -> BVH:
    """Native builder when available, jitted device build otherwise.
    ``builder``: "sah" (quality, static scenes) or "lbvh" (fast build);
    SAH falls back to LBVH when the native library is unavailable (the
    numpy SAH is too slow at scene scale: 37 s at 284k tris)."""
    if builder == "sah":
        out = build_sah_native(v0, v1, v2)
        if out is not None:
            return out
    out = build_bvh_native(v0, v1, v2)
    return out if out is not None else build_bvh(v0, v1, v2)


def refit_plan(left, right, num_tris):
    """Host-side range-minimum-query refit plan (once per topology).

    Both in-repo builders (Karras LBVH, top-down binned SAH — see
    native/bvh_builder.cpp) give every internal node a CONTIGUOUS range
    of the sorted leaf order, so its AABB is a range-min/max over the
    leaf boxes: with a doubling sparse table st[k][i] = min over
    [i, i+2^k), node i's box is min(st[k][lo], st[k][hi+1-2^k]) for
    k = floor(log2(len)). The table build is K shifted elementwise
    passes (bandwidth-cheap) instead of refit_bvh's ~height full-array
    gather sweeps.

    Returns (rows, K): rows (2, T-1) int32 of flattened (k*T + pos)
    indices into the stacked table, or (None, 0) when a node's range is
    non-contiguous (foreign tree) or T <= 2.
    """
    import numpy as np

    T = int(num_tris)
    if T <= 2:
        return None, 0
    lf = np.asarray(left[: T - 1]).astype(np.int64)
    rt = np.asarray(right[: T - 1]).astype(np.int64)
    N = 2 * T - 1
    lo = np.full(N, -1, np.int64)
    hi = np.full(N, -1, np.int64)
    cnt = np.zeros(N, np.int64)
    lo[T - 1:] = np.arange(T)
    hi[T - 1:] = np.arange(T)
    cnt[T - 1:] = 1
    for _ in range(200):
        ready = (lo[lf] >= 0) & (lo[rt] >= 0)
        unset = lo[: T - 1] < 0
        upd = ready & unset
        if not upd.any():
            break
        lo[: T - 1] = np.where(upd, np.minimum(lo[lf], lo[rt]), lo[: T - 1])
        hi[: T - 1] = np.where(upd, np.maximum(hi[lf], hi[rt]), hi[: T - 1])
        cnt[: T - 1] = np.where(upd, cnt[lf] + cnt[rt], cnt[: T - 1])
    ilo, ihi, icnt = lo[: T - 1], hi[: T - 1], cnt[: T - 1]
    if (ilo < 0).any() or (icnt != ihi - ilo + 1).any():
        return None, 0
    length = ihi - ilo + 1
    # exact floor(log2) for integers: frexp exponent - 1
    k = (np.frexp(length.astype(np.float64))[1] - 1).astype(np.int64)
    g2 = ihi + 1 - (1 << k)
    rows = np.stack([k * T + ilo, k * T + g2]).astype(np.int32)
    return rows, int(k.max())


@functools.partial(jax.jit, static_argnames=("K",))
def refit_bvh_rmq(bvh: BVH, v0, v1, v2, rows, K: int) -> BVH:
    """Frozen-topology AABB refit via the refit_plan sparse table:
    K shifted elementwise min/max passes + 2 row gathers — replaces
    refit_bvh's ~height full-array sweeps (bit-identical boxes: both
    compute exact min/max unions over the same leaf sets)."""
    T = v0.shape[0]
    lt = bvh.tri[T - 1:]
    sv0, sv1, sv2 = v0[lt], v1[lt], v2[lt]
    leaf_min = jnp.minimum(jnp.minimum(sv0, sv1), sv2)
    leaf_max = jnp.maximum(jnp.maximum(sv0, sv1), sv2)
    lv_min = [leaf_min]
    lv_max = [leaf_max]
    for k in range(1, K + 1):
        h = 1 << (k - 1)
        pmin, pmax = lv_min[-1], lv_max[-1]
        if h < T:
            smin = jnp.concatenate([pmin[h:], pmin[-h:]])
            smax = jnp.concatenate([pmax[h:], pmax[-h:]])
        else:
            smin, smax = pmin, pmax
        lv_min.append(jnp.minimum(pmin, smin))
        lv_max.append(jnp.maximum(pmax, smax))
    tmin = jnp.concatenate(lv_min, axis=0)
    tmax = jnp.concatenate(lv_max, axis=0)
    imin = jnp.minimum(tmin[rows[0]], tmin[rows[1]])
    imax = jnp.maximum(tmax[rows[0]], tmax[rows[1]])
    return dataclasses.replace(
        bvh,
        node_min=jnp.concatenate([imin, leaf_min]).astype(jnp.float32),
        node_max=jnp.concatenate([imax, leaf_max]).astype(jnp.float32))


def tree_height(left, right, num_tris) -> int:
    """Host-side internal-node height of the root (levels of internal
    nodes). refit_bvh's bottom-up scan converges in exactly this many
    iterations — computed once per topology at build time so dynamic
    refits don't pay the conservative 2*log2(T)+8 bound (~40 iters at
    65k tris vs a measured SAH height of ~2x less)."""
    T = int(num_tris)
    if T <= 1:
        return 1
    import numpy as np

    lf = np.asarray(left[: T - 1])
    rt = np.asarray(right[: T - 1])
    cur = np.array([0], np.int64)
    h = 0
    while cur.size:
        h += 1
        children = np.concatenate([lf[cur], rt[cur]])
        cur = children[children < T - 1]
    return h


@functools.partial(jax.jit, static_argnames=("max_depth_iters",))
def refit_bvh(bvh: BVH, v0, v1, v2, max_depth_iters: int = 64) -> BVH:
    """Frozen-topology AABB refit for dynamic scenes.

    The reference rebuilds its TLAS when instances move
    (Scene.cpp:323-440, UPDATE-vs-REBUILD is a driver choice under
    PREFER_FAST_TRACE); here we keep the Karras topology (left/
    right/tri untouched — still a valid BVH for any geometry, only
    traversal efficiency degrades under large deformation) and re-run
    the bottom-up AABB propagation on-device. All-jnp; the kernel's node
    records are repacked from the result (trace_cuda.pack_nodes).
    """
    T = v0.shape[0]
    if T <= 1:
        tmin = jnp.minimum(jnp.minimum(v0, v1), v2).reshape(-1, 3)
        tmax = jnp.maximum(jnp.maximum(v0, v1), v2).reshape(-1, 3)
        pad = bvh.node_min.shape[0] - tmin.shape[0]
        return dataclasses.replace(
            bvh,
            node_min=jnp.pad(tmin, ((0, pad), (0, 0))),
            node_max=jnp.pad(tmax, ((0, pad), (0, 0))))

    # leaf AABBs in the frozen sorted order
    lt = bvh.tri[T - 1:]
    sv0, sv1, sv2 = v0[lt], v1[lt], v2[lt]
    leaf_min = jnp.minimum(jnp.minimum(sv0, sv1), sv2)
    leaf_max = jnp.maximum(jnp.maximum(sv0, sv1), sv2)
    node_min = jnp.concatenate([jnp.full((T - 1, 3), jnp.inf), leaf_min])
    node_max = jnp.concatenate([jnp.full((T - 1, 3), -jnp.inf), leaf_max])

    left = bvh.left[: T - 1]
    right = bvh.right[: T - 1]

    def prop(carry, _):
        nmin, nmax = carry
        new_min = nmin.at[: T - 1].set(
            jnp.minimum(nmin[left], nmin[right]))
        new_max = nmax.at[: T - 1].set(
            jnp.maximum(nmax[left], nmax[right]))
        return (new_min, new_max), None

    # 64 = "height unknown" default → the conservative 2*log2+8 bound;
    # callers that computed the exact height (bvh.tree_height, stored on
    # SceneTracer at build) pass it and the scan runs exactly that many
    # bottom-up sweeps (~2x fewer on measured SAH trees)
    if max_depth_iters >= 64:
        iters = min(max_depth_iters,
                    max(2, math.ceil(math.log2(T)) * 2 + 8))
    else:
        iters = max(2, max_depth_iters)
    (node_min, node_max), _ = jax.lax.scan(prop, (node_min, node_max),
                                           None, length=iters)
    return dataclasses.replace(bvh,
                               node_min=node_min.astype(jnp.float32),
                               node_max=node_max.astype(jnp.float32))


def validate_bvh(bvh: BVH, v0, v1, v2) -> bool:
    """Host-side sanity check: every triangle is inside its leaf AABB and
    every node AABB contains its children (test utility)."""
    import numpy as np

    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    tri = np.asarray(bvh.tri)
    T = int(bvh.num_tris)
    if T <= 1:
        return True
    for n in range(T - 1):
        for c in (left[n], right[n]):
            if not (nmin[n] <= nmin[c] + 1e-5).all():
                return False
            if not (nmax[n] >= nmax[c] - 1e-5).all():
                return False
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    for k in range(T):
        node = T - 1 + k
        t = tv[tri[node]]
        if not (t.min(0) >= nmin[node] - 1e-5).all():
            return False
        if not (t.max(0) <= nmax[node] + 1e-5).all():
            return False
    return True
