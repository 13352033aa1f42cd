"""Ray traversal + hit shading — the ray-query / RT-pipeline replacement.

Three traversal engines with one contract:
  * ``intersect_brute``  — O(T·R) reference oracle for tests
  * ``intersect_bvh``    — batched stack traversal (jnp while_loop; every
    ray keeps its own stack; gathers are XLA-vectorized). The CPU path
    and the reference the kernel is held to.
  * ops/trace_cuda.py    — one-thread-per-ray CUDA kernel over the same
    binary tree (the GPU path).

``SceneTracer`` packages a built BVH with the two hooks the render passes
consume (graph/rt_passes.py):
  shadow_query(pos, normal, dir, tmax) → visibility   (ray-query analog,
      common.glsl:124-153 CalculateRayQueryShadow)
  trace_radiance(origin, dir, ctx, depth) → (rgb, dist)  (traceRayEXT +
      closesthit.rchit / miss.rmiss shading)
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths
from ..core.types import RenderFlags
from ..scene import schema
from . import image as img_ops
from . import backend as backend_mod
from . import sampling, shade, sky, texture, trace_cuda
from .bvh import BVH, build_bvh_host, refit_bvh

TRI_EPS = 1e-9
STACK_DEPTH = 64


# ---------------------------------------------------------------------------
# Primitive tests
# ---------------------------------------------------------------------------

def ray_triangle(o, d, p0, p1, p2, tmin, tmax):
    """Möller–Trumbore, both-faced. Returns (hit, t, u, v)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = maths.cross(d, e2)
    det = maths.dot(e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < TRI_EPS, TRI_EPS, det)
    tvec = o - p0
    u = maths.dot(tvec, pvec) * inv_det
    qvec = maths.cross(tvec, e1)
    v = maths.dot(d, qvec) * inv_det
    t = maths.dot(e2, qvec) * inv_det
    hit = ((jnp.abs(det) >= TRI_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= tmin) & (t <= tmax))
    return hit, t, u, v


def ray_aabb(o, inv_d, bmin, bmax, tmin, tmax):
    """Slab test; inv_d precomputed (inf-safe). Returns (hit, tnear)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tn <= tf) & (tf >= tmin) & (tn <= tmax)
    return hit, tn


# ---------------------------------------------------------------------------
# Brute-force oracle
# ---------------------------------------------------------------------------

def intersect_brute(v0, v1, v2, o, d, tmin, tmax, any_hit=False):
    """All rays × all triangles. Returns (t, tri, u, v); tri=-1 on miss.
    Rays flat (R, 3)."""
    def per_ray(oo, dd, tmx):
        hit, t, u, v = ray_triangle(oo[None], dd[None], v0, v1, v2, tmin, tmx)
        t_masked = jnp.where(hit, t, jnp.inf)
        k = jnp.argmin(t_masked)
        return (jnp.where(hit[k], t_masked[k], jnp.inf),
                jnp.where(hit[k], k, -1).astype(jnp.int32), u[k], v[k])

    tmx = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), o.shape[:-1])
    return jax.vmap(per_ray)(o, d, tmx)


# ---------------------------------------------------------------------------
# Batched BVH traversal (SIMT-style while_loop)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("any_hit", "max_iters"))
def intersect_bvh(bvh: BVH, tri_v0, tri_v1, tri_v2, o, d, tmin, tmax,
                  any_hit: bool = False, max_iters: int = 10_000):
    """Stack traversal over a ray batch; rays flat (R, 3).

    Returns (t, tri, u, v) with tri = -1 for miss (t = +inf). With
    ``any_hit`` the search stops at the first confirmed hit per ray
    (gl_RayFlagsTerminateOnFirstHitEXT analog).
    """
    R = o.shape[0]
    T = tri_v0.shape[0]
    n_internal = jnp.maximum(bvh.num_tris - 1, 0)
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    tmax_in = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (R,))

    stack = jnp.zeros((R, STACK_DEPTH), jnp.int32)
    # root = 0 when internal nodes exist, else the single leaf node 0
    stack = stack.at[:, 0].set(0)
    sp = jnp.ones((R,), jnp.int32)

    init = dict(
        stack=stack, sp=sp,
        t=tmax_in, tri=jnp.full((R,), -1, jnp.int32),
        u=jnp.zeros((R,), jnp.float32), v=jnp.zeros((R,), jnp.float32),
        iters=jnp.int32(0),
    )

    def cond(s):
        return jnp.any(s["sp"] > 0) & (s["iters"] < max_iters)

    def body(s):
        active = s["sp"] > 0
        sp1 = jnp.maximum(s["sp"] - 1, 0)
        node = s["stack"][jnp.arange(R), sp1]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp1, s["sp"])

        is_leaf = node >= n_internal
        # --- leaf: triangle test ---
        tri_id = bvh.tri[node]
        safe_tri = jnp.clip(tri_id, 0, T - 1)
        hit, t, u, v = ray_triangle(
            o, d, tri_v0[safe_tri], tri_v1[safe_tri], tri_v2[safe_tri],
            tmin, s["t"])
        take = active & is_leaf & hit & (tri_id >= 0)
        new_t = jnp.where(take, t, s["t"])
        new_tri = jnp.where(take, tri_id, s["tri"])
        new_u = jnp.where(take, u, s["u"])
        new_v = jnp.where(take, v, s["v"])
        if any_hit:
            # terminate ray: clear its stack
            sp = jnp.where(take, 0, sp)

        # --- internal: AABB test both children, push near last ---
        left = bvh.left[node]
        right = bvh.right[node]
        lmin = bvh.node_min[left]
        lmax = bvh.node_max[left]
        rmin = bvh.node_min[right]
        rmax = bvh.node_max[right]
        lhit, lt = ray_aabb(o, inv_d, lmin, lmax, tmin, new_t)
        rhit, rt = ray_aabb(o, inv_d, rmin, rmax, tmin, new_t)
        inner = active & (~is_leaf)
        lhit = lhit & inner
        rhit = rhit & inner

        # order: push far child first so near is popped first
        l_nearer = lt <= rt
        first = jnp.where(l_nearer, right, left)     # pushed first (far)
        first_ok = jnp.where(l_nearer, rhit, lhit)
        second = jnp.where(l_nearer, left, right)    # pushed last (near)
        second_ok = jnp.where(l_nearer, lhit, rhit)

        rows = jnp.arange(R)
        idx1 = jnp.where(first_ok, sp, STACK_DEPTH)  # OOB index drops write
        stack1 = s["stack"].at[rows, jnp.clip(idx1, 0, STACK_DEPTH - 1)].set(
            jnp.where(first_ok, first, s["stack"][rows, jnp.clip(idx1, 0, STACK_DEPTH - 1)]))
        sp_after1 = sp + first_ok.astype(jnp.int32)
        idx2 = jnp.where(second_ok, sp_after1, STACK_DEPTH)
        stack2 = stack1.at[rows, jnp.clip(idx2, 0, STACK_DEPTH - 1)].set(
            jnp.where(second_ok, second, stack1[rows, jnp.clip(idx2, 0, STACK_DEPTH - 1)]))
        sp_final = sp_after1 + second_ok.astype(jnp.int32)

        return dict(stack=stack2, sp=sp_final, t=new_t, tri=new_tri,
                    u=new_u, v=new_v, iters=s["iters"] + 1)

    out = jax.lax.while_loop(cond, body, init)
    missed = out["tri"] < 0
    return (jnp.where(missed, jnp.inf, out["t"]), out["tri"],
            out["u"], out["v"])


def _shade_fetch_mode(settings) -> str:
    """Hit-shading attribute-fetch mode: settings.shade_fetch (static —
    in-process A/Bs retrace) → env SHADE_FETCH → "auto". "auto" prefers
    scene.shade_rows (u16 fast gather), then attr_rows, then the narrow
    per-attribute gathers; "attr" skips shade_rows; "pixel" forces the
    narrow path."""
    mode = getattr(settings, "shade_fetch", None)
    if mode is None:
        mode = os.environ.get("SHADE_FETCH", "auto")
    return mode


# ---------------------------------------------------------------------------
# SceneTracer: BVH + shading hooks
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneTracer:
    """BVH handle + traversal/shading methods. A pytree — pass it through
    ``jax.jit`` as an argument (the Renderer does) so BVH arrays stay
    device buffers rather than baked constants. Scene data is taken
    per-call to share the frame function's traced scene."""

    bvh: BVH
    # packed node / leaf-triangle records the CUDA kernel reads
    # (trace_cuda.pack_nodes); None on the jnp backend
    nodes: Any = None
    leaf_tris: Any = None
    root: "int | None" = dataclasses.field(metadata=dict(static=True),
                                           default=0)
    backend: str = dataclasses.field(metadata=dict(static=True),
                                     default="jnp")
    ray_chunk: int = dataclasses.field(metadata=dict(static=True),
                                       default=131072)
    # exact internal-node height of the binary tree (bvh.tree_height),
    # computed once at build: refit_bvh converges in exactly this many
    # bottom-up sweeps (vs the conservative ~40-iter bound)
    bvh_height: int = dataclasses.field(metadata=dict(static=True),
                                        default=64)
    # RMQ refit plan (bvh.refit_plan): (2, T-1) i32 sparse-table rows +
    # static table depth — refit runs K shifted elementwise passes
    # instead of bvh_height full-array gather sweeps when present
    rmq_rows: Any = None
    rmq_k: int = dataclasses.field(metadata=dict(static=True), default=0)

    @staticmethod
    def build(scene_data, settings=None) -> "SceneTracer":
        soup = scene_data.triangles
        # native host builder; "auto" = binned SAH, the PREFER_FAST_TRACE
        # analog (Scene.cpp:397)
        requested_builder = getattr(settings, "bvh_builder", "auto") \
            if settings is not None else "auto"
        builder = "sah" if requested_builder == "auto" else requested_builder
        bvh = build_bvh_host(soup.v0, soup.v1, soup.v2, builder=builder)
        requested = settings.trace_backend if settings is not None else "auto"
        backend = backend_mod.resolve(requested)
        nodes = leaf_tris = None
        if backend == "kernel":
            nodes, leaf_tris = _pack(bvh, soup.v0, soup.v1, soup.v2)
        from .bvh import refit_plan, tree_height

        rows, K = refit_plan(bvh.left, bvh.right, soup.count)
        return SceneTracer(bvh=bvh, nodes=nodes, leaf_tris=leaf_tris,
                           root=trace_cuda.root_ref(soup.count),
                           backend=backend,
                           bvh_height=tree_height(bvh.left, bvh.right,
                                                  soup.count),
                           rmq_rows=None if rows is None
                           else jnp.asarray(rows),
                           rmq_k=K)

    def refit(self, scene_data) -> "SceneTracer":
        """Topology-frozen acceleration-structure refit after a geometry
        update (scene/dynamic.update_transforms) — the per-frame TLAS
        re-sync analog (Scene.cpp:148-189). All-device, no host work:
        the kernel's node records are repacked from the refit boxes."""
        soup = scene_data.triangles
        if self.rmq_rows is not None:
            from .bvh import refit_bvh_rmq

            new_bvh = refit_bvh_rmq(self.bvh, soup.v0, soup.v1, soup.v2,
                                    self.rmq_rows, self.rmq_k)
        else:
            new_bvh = refit_bvh(self.bvh, soup.v0, soup.v1, soup.v2,
                                max_depth_iters=self.bvh_height)
        nodes, leaf_tris = self.nodes, self.leaf_tris
        if self.backend == "kernel":
            nodes, leaf_tris = _pack(new_bvh, soup.v0, soup.v1, soup.v2)
        return dataclasses.replace(self, bvh=new_bvh, nodes=nodes,
                                   leaf_tris=leaf_tris)

    ALPHA_ROUNDS = 4   # transparency-continuation depth (cut-out layers)

    def surface_alpha(self, scene, tri, u, v):
        """(is_masked_material, alpha, cutoff) at a hit — the texture
        fetch of the reference's any-hit loop (common.glsl:139-148)."""
        soup = scene.triangles
        safe = jnp.clip(tri, 0, soup.count - 1)
        b1 = u[..., None]
        b2 = v[..., None]
        if scene.attr_rows is not None:
            # one wide gather: uv of all three verts + packed material
            # row (tex id / alpha mode / cutoff ride along — gather-free)
            row = scene.attr_rows[safe]
            uv = row[..., 13:15] * (1.0 - b1 - b2) \
                + row[..., 28:30] * b1 + row[..., 43:45] * b2
            tex = row[..., 77].astype(jnp.int32)
            is_mask = (row[..., 81].astype(jnp.int32) == 1) & (tex >= 0)
            cutoff = row[..., 82]
        else:
            inst = jnp.clip(soup.instance[safe], 0,
                            scene.instances.material.shape[0] - 1)
            mat = scene.instances.material[inst]
            uvs = scene.vertices.uv
            uv = uvs[soup.i0[safe]] * (1.0 - b1 - b2) \
                + uvs[soup.i1[safe]] * b1 + uvs[soup.i2[safe]] * b2
            tex = scene.materials.colour_texture[mat]
            is_mask = (scene.materials.alpha_mode[mat] == 1) & (tex >= 0)
            cutoff = scene.materials.alpha_cutoff[mat]
        rgba = texture.sample_stack(
            scene.textures, tex, uv, jnp.ones((4,), jnp.float32))
        return is_mask, rgba[..., 3], cutoff

    def _occluded_alpha(self, scene, origin, direction, tmin, tmax, active):
        """Occlusion with transparent (cut-out) surface skipping.

        The reference enumerates ray-query candidates and `continue`s
        texels with alpha < cutoff (common.glsl:139-148, shadow.rahit).
        Formulation here: up to ALPHA_ROUNDS closest-hit rounds;
        transparent hits advance the origin past the surface and
        re-trace. (Closest-hit, not any-hit: advancing past an
        arbitrary any-hit candidate could jump over a nearer opaque
        surface.)"""
        o = origin
        occluded = jnp.zeros(origin.shape[0], bool)
        live = jnp.ones(origin.shape[0], bool) if active is None else active
        tmax_rem = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32),
                                    (origin.shape[0],))
        for _ in range(self.ALPHA_ROUNDS):
            t, tri, u, v = self._intersect(scene, o, direction, tmin,
                                           tmax_rem, any_hit=False,
                                           active=live)
            hit = live & (tri >= 0) & (tri < (1 << 29))
            is_mask, alpha, cutoff = self.surface_alpha(scene, tri, u, v)
            transparent = hit & is_mask & (alpha < cutoff)
            occluded = occluded | (hit & ~transparent)
            live = transparent
            step = jnp.where(live, t + 1e-3, 0.0)
            o = o + direction * step[..., None]
            tmax_rem = jnp.maximum(tmax_rem - step, 0.0)
        return occluded

    # --- occlusion ------------------------------------------------------
    def occluded(self, scene, origin, direction, tmax, active=None):
        """flat-batch any-hit query → visibility (1.0 = unoccluded).
        ``active=False`` rays are skipped (result 0.0, callers mask)."""
        if scene.has_alpha_test:
            occ = self._occluded_alpha(scene, origin, direction, 1e-3,
                                       tmax, active)
            return jnp.where(occ, 0.0, 1.0)
        t, tri, _, _ = self._intersect(scene, origin, direction, 1e-3, tmax,
                                       any_hit=True, active=active)
        return jnp.where(tri >= 0, 0.0, 1.0)

    def shadow_query(self, scene, world_pos, normal, direction, tmax,
                     active=None, layout: str = "tile"):
        """CalculateRayQueryShadow contract over (H, W) images: origins are
        offset along the normal (OffsetRay, common.glsl:155-167); tMax is
        capped at 10000 with tmin 0.01 (common.glsl:127-129). ``active``
        (H, W) masks rays out entirely (background pixels): they cost no
        traversal steps and stop blocking packet early termination.

        ``layout`` picks the ray→packet order (all pure relayouts):
          "flat"    — raster scanline order (1024×1 strips per packet)
          "tile"    — 32×32 pixel tiles per packet: compact origin
                      footprint → smaller per-packet BVH node unions
          "pattern" — interleave-pattern-major (to_pattern_major); pair
                      with sampling.interleaved_cos_hemisphere so each
                      packet also shares one local direction (AO)."""
        H, W = world_pos.shape[:2]
        origin_img = sampling.offset_ray(world_pos, normal)
        tmax_c = jnp.minimum(jnp.asarray(tmax, jnp.float32), 10000.0)
        if layout == "pattern":
            fwd = img_ops.to_pattern_major
            inv = img_ops.from_pattern_major
        elif layout == "tile":
            fwd = img_ops.to_tile_major
            inv = img_ops.from_tile_major
        else:
            fwd = inv = None
        if fwd is not None:
            origin, _ = fwd(origin_img)
            d, _ = fwd(direction)
            act_img = jnp.ones((H, W), bool) if active is None else active
            act, _ = fwd(act_img)
        else:
            origin = origin_img.reshape(-1, 3)
            d = direction.reshape(-1, 3)
            act = None if active is None else active.reshape(-1)
        if scene.has_alpha_test:
            occ = self._occluded_alpha(scene, origin, d, 0.01, tmax_c, act)
            vis = jnp.where(occ, 0.0, 1.0)
        else:
            t, tri, _, _ = self._intersect(
                scene, origin, d, 0.01, tmax_c, any_hit=True, active=act)
            vis = jnp.where(tri >= 0, 0.0, 1.0)
        if inv is not None:
            return inv(vis, H, W)
        return vis.reshape(H, W)

    def shadow_query_pair(self, scene, world_pos, normal,
                          dir_a, tmax_a, dir_b, tmax_b,
                          active=None, layout: str = "tile"):
        """TWO any-hit queries from the same surface points (sun/light
        shadow + AO) fused into ONE traversal dispatch with per-ray
        tMax — same per-ray results as two shadow_query calls (any-hit
        visibility is ray-order-independent), one dispatch instead of
        two. Returns (vis_a, vis_b)."""
        H, W = world_pos.shape[:2]
        origin_img = sampling.offset_ray(world_pos, normal)
        fwd = (img_ops.to_pattern_major if layout == "pattern"
               else img_ops.to_tile_major)
        inv = (img_ops.from_pattern_major if layout == "pattern"
               else img_ops.from_tile_major)
        origin, _ = fwd(origin_img)
        da, _ = fwd(dir_a)
        db, _ = fwd(dir_b)
        act_img = jnp.ones((H, W), bool) if active is None else active
        act, _ = fwd(act_img)
        R = origin.shape[0]
        o2 = jnp.concatenate([origin, origin])
        d2 = jnp.concatenate([da, db])
        t2 = jnp.concatenate([
            jnp.full((R,), jnp.minimum(jnp.asarray(tmax_a, jnp.float32),
                                       10000.0)),
            jnp.full((R,), jnp.minimum(jnp.asarray(tmax_b, jnp.float32),
                                       10000.0))])
        a2 = jnp.concatenate([act, act])
        if scene.has_alpha_test:
            occ = self._occluded_alpha(scene, o2, d2, 0.01, t2, a2)
            vis = jnp.where(occ, 0.0, 1.0)
        else:
            t, tri, _, _ = self._intersect(scene, o2, d2, 0.01, t2,
                                           any_hit=True, active=a2)
            vis = jnp.where(tri >= 0, 0.0, 1.0)
        return inv(vis[:R], H, W), inv(vis[R:], H, W)

    def _intersect(self, scene, o, d, tmin, tmax, any_hit, active=None):
        soup = scene.triangles
        if self.backend == "kernel":
            return trace_cuda.intersect(self.nodes, self.leaf_tris,
                                        self.root, o, d, tmin, tmax,
                                        any_hit=any_hit, active=active)
        if active is not None:
            # inactive rays get tmax 0: they can hit nothing
            tmax = jnp.where(
                active, jnp.broadcast_to(jnp.asarray(tmax, jnp.float32),
                                         active.shape), 0.0)
        R = o.shape[0]
        C = self.ray_chunk
        if R <= C:
            return intersect_bvh(self.bvh, soup.v0, soup.v1, soup.v2, o, d,
                                 tmin, tmax, any_hit=any_hit)
        # chunk rays so per-ray traversal stacks stay within memory budget
        pad = (-R) % C
        tmax_full = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (R,))
        oc = jnp.pad(o, ((0, pad), (0, 0))).reshape(-1, C, 3)
        dc = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0).reshape(-1, C, 3)
        tc = jnp.pad(tmax_full, (0, pad)).reshape(-1, C)

        def one(args):
            co, cd, ct = args
            return intersect_bvh(self.bvh, soup.v0, soup.v1, soup.v2,
                                 co, cd, tmin, ct, any_hit=any_hit)

        t, tri, u, v = jax.lax.map(one, (oc, dc, tc))
        flat = lambda x: x.reshape(-1)[:R]
        return flat(t), flat(tri), flat(u), flat(v)

    # --- radiance (closesthit.rchit + miss.rmiss) -----------------------
    def trace_radiance(self, scene, origin, direction, ctx, depth: int = 0,
                       active=None, pix_offset=0, layout: str = "tile"):
        """Trace + shade closest hits. origin/direction (..., 3); returns
        (rgb (..., 3), hit distance (...,) with -1 on miss).

        ``active`` (lead-shaped bool) skips rays entirely (their result
        is the sky/miss value — callers mask afterwards anyway, e.g.
        the reflection pass's roughness cutoff). (H, W) inputs are
        relayouted tile-major so traversal packets get compact origin
        footprints (same reasoning as shadow_query layout="tile");
        ``layout="pattern"`` groups by interleave pattern instead — for
        rays whose directions were drawn with
        sampling.interleaved_cos_hemisphere, each packet then carries
        essentially ONE local direction (the AO trick, applied to GI).
        ``pix_offset`` shifts the NEE seed pixel index — shard_map
        callers pass the shard's global row offset so sharded output
        matches single-device exactly."""
        lead = origin.shape[:-1]
        img_mode = len(lead) == 2
        if img_mode:
            H, W = lead
            relay = (img_ops.to_pattern_major if layout == "pattern"
                     else img_ops.to_tile_major)
            o, _ = relay(origin)
            d, _ = relay(direction)
            act = None
            if active is not None:
                act, _ = relay(active)
            # NEE seeds follow the ORIGINAL pixel index so the result is
            # layout-independent (and matches the pre-relayout goldens)
            pix = (jnp.arange(H * W, dtype=jnp.uint32).reshape(H, W)
                   + jnp.asarray(pix_offset, jnp.uint32))
            ray_idx, _ = relay(pix)
        else:
            o = origin.reshape(-1, 3)
            d = direction.reshape(-1, 3)
            act = None if active is None else active.reshape(-1)
            ray_idx = None
        t, tri, u, v = self._intersect(scene, o, d, 0.01, 1e6,
                                       any_hit=False, active=act)
        # inactive lanes come back with the sentinel "hit" id — mask them
        hit = (tri >= 0) & (tri < (1 << 29))
        if act is not None:
            hit = hit & act
        if scene.has_alpha_test:
            # skip transparent cut-out texels (closesthit never sees them
            # in the reference because shadow.rahit ignores them)
            o_adv = o
            t_off = jnp.zeros_like(t)
            for _ in range(self.ALPHA_ROUNDS - 1):
                is_mask, alpha, cutoff = self.surface_alpha(
                    scene, tri, u, v)
                transparent = hit & is_mask & (alpha < cutoff)
                step = jnp.where(transparent, t + 1e-3, 0.0)
                o_adv = o_adv + d * step[..., None]
                t_off = t_off + step
                t2, tri2, u2, v2 = self._intersect(
                    scene, o_adv, d, 0.01, 1e6, any_hit=False,
                    active=transparent)
                t = jnp.where(transparent, t2, t)
                tri = jnp.where(transparent, tri2, tri)
                u = jnp.where(transparent, u2, u)
                v = jnp.where(transparent, v2, v)
                hit = (tri >= 0) & (tri < (1 << 29))
                if act is not None:
                    hit = hit & act
            t = t + t_off

        stage = getattr(ctx.settings, "debug_radiance_stage", "full")
        if stage == "noshade":
            # diagnostic rung: closest-hit traversal only (hits black)
            rgb_hit = jnp.zeros((*t.shape, 3), jnp.float32)
        else:
            rgb_hit = self._shade_hit(scene, o, d, t, tri, u, v, ctx,
                                      active=hit, ray_idx=ray_idx,
                                      stage=stage)
        rgb_miss = sky.sample_environment(
            d, scene.sky_texture, scene.textures,
            bool(ctx.settings.flags & RenderFlags.IBL),
            has_sky=scene.has_sky_texture)
        rgb = jnp.where(hit[..., None], rgb_hit, rgb_miss)
        dist = jnp.where(hit, t, -1.0)
        if img_mode:
            unrelay = (img_ops.from_pattern_major if layout == "pattern"
                       else img_ops.from_tile_major)
            return unrelay(rgb, H, W), unrelay(dist, H, W)
        return rgb.reshape(*lead, 3), dist.reshape(lead)

    def _shade_hit(self, scene, o, d, t, tri, u, v, ctx, active=None,
                   ray_idx=None, stage="full"):
        """closesthit.rchit:23-130 — interpolate attributes, evaluate
        material, sun NEE + emissive-light NEE (both shadowed), IBL
        ambient, emission. ``active`` (= the hit mask) skips the
        shading occlusion traversals for missed/inactive rays.
        ``stage`` is settings.debug_radiance_stage (DIAGNOSTIC ONLY,
        core/config.py): "noocc" treats occlusion queries as unoccluded
        (no traversal); "noattr" = noocc + constant surface attributes
        (isolates the attr-row gather); "nonee" = noocc + the emissive-
        light NEE block skipped (isolates sample_lights + its gathers)."""
        sc = scene
        params = ctx.params
        flags = ctx.settings.flags
        soup = sc.triangles
        safe = jnp.clip(tri, 0, soup.count - 1)
        skip_occlusion = stage in ("noocc", "noattr", "nonee")

        b0 = (1.0 - u - v)[..., None]
        b1 = u[..., None]
        b2 = v[..., None]
        world_pos = o + d * t[..., None]

        # Attribute fetch: ONE wide gather from the pre-joined per-
        # triangle rows (scene.attr_rows) replaces ~12 narrow per-ray
        # gathers (3 verts x 3 attrs + soup indices + instance rows).
        # SHADE_FETCH=pixel keeps the narrow path for A/B probes.
        mrow = None
        if stage == "noattr":
            # gather-free constant surface: flat normal facing the ray,
            # material row 0 — timing diagnostics only
            from .shade import _pack_materials

            geo_n = -maths.normalize(d)
            uv = jnp.zeros((*safe.shape, 2), jnp.float32)
            mrow = jnp.broadcast_to(_pack_materials(sc.materials)[0],
                                    (*safe.shape, 16))
            mat_id = jnp.zeros(safe.shape, jnp.int32)
            wt = jnp.concatenate(
                [maths.normalize(jnp.cross(geo_n, geo_n + 0.3)),
                 jnp.ones((*safe.shape, 1), jnp.float32)], axis=-1)
        elif _shade_fetch_mode(ctx.settings) == "auto" \
                and sc.shade_rows_q is not None:
            # Sponza-scale quantized fetch: the exact u16 table exceeds
            # its size gate (schema.SHADE_ROWS_MAX), so gather a 29-col
            # u16 row (bf16 local normals/tangents, exact uv base + f16
            # deltas) + a KB-scale per-instance side row
            # (schema.build_shade_rows_q)
            qrow = sc.shade_rows_q[safe]
            inst = jnp.clip(qrow[..., schema.SHQ_INST].astype(jnp.int32),
                            0, sc.inst_shade.shape[0] - 1)
            # per-instance side rows have NEAR-UNIFORM indices (rays
            # hitting one object; see texture.spread_gather)
            from .texture import spread_gather as _sg

            srow = schema.decode_shade_rows_q(qrow, _sg(sc.inst_shade,
                                                        inst))
            lerp = srow[..., 0:9] * b0 + srow[..., 9:18] * b1 \
                + srow[..., 18:27] * b2
            ln = lerp[..., 0:3]
            lt = lerp[..., 3:7]
            uv = lerp[..., 7:9]
            nmat = srow[..., 27:36].reshape(*safe.shape, 3, 3)
            mat_id = srow[..., 36].astype(jnp.int32)
            mrow = srow[..., 37:53]
        elif _shade_fetch_mode(ctx.settings) == "auto" \
                and sc.shade_rows is not None:
            # u16 table: one (R, 106) uint16 gather + exact bitcast
            # reconstruction (schema.encode_shade_rows)
            srow = schema.decode_shade_rows(sc.shade_rows[safe])
            lerp = srow[..., 0:9] * b0 + srow[..., 9:18] * b1 \
                + srow[..., 18:27] * b2
            ln = lerp[..., 0:3]
            lt = lerp[..., 3:7]
            uv = lerp[..., 7:9]
            nmat = srow[..., 27:36].reshape(*safe.shape, 3, 3)
            mat_id = srow[..., 36].astype(jnp.int32)
            mrow = srow[..., 37:53]
        elif _shade_fetch_mode(ctx.settings) != "pixel" \
                and sc.attr_rows is not None:
            row = sc.attr_rows[safe]
            if os.environ.get("SHADE_ROW_BARRIER", "0") == "1":
                # probe knob: pin the wide gather to materialize ONCE —
                # its many consumers (normal/tangent/uv/nmat/mrow
                # chains) otherwise invite fuse-duplication (suspected
                # in the batch-2 nonee paradox)
                row = jax.lax.optimization_barrier(row)
            # normal+tangent+uv sit at [6:15] of each 15-wide vertex
            # block (scene/schema.py attr_rows layout)
            lerp = row[..., 6:15] * b0 + row[..., 21:30] * b1 \
                + row[..., 36:45] * b2
            ln = lerp[..., 0:3]
            lt = lerp[..., 3:7]
            uv = lerp[..., 7:9]
            nmat = row[..., 45:54].reshape(*safe.shape, 3, 3)
            mat_id = row[..., 66].astype(jnp.int32)
            mrow = row[..., 67:83]                 # packed material row
        else:
            i0, i1, i2 = soup.i0[safe], soup.i1[safe], soup.i2[safe]
            verts = sc.vertices
            uv = verts.uv[i0] * b0 + verts.uv[i1] * b1 + verts.uv[i2] * b2
            ln = verts.normal[i0] * b0 + verts.normal[i1] * b1 \
                + verts.normal[i2] * b2
            lt = verts.tangent[i0] * b0 + verts.tangent[i1] * b1 \
                + verts.tangent[i2] * b2
            inst = soup.instance[safe]
            nmat = sc.instances.normal_transform[inst][..., :3, :3]
            mat_id = sc.instances.material[inst]

        if stage != "noattr":
            geo_n = maths.normalize(maths.matvec(nmat, ln))
            # face backfacing rays (closesthit.rchit:56)
            flip = maths.dot(geo_n, d, keepdims=True) > 0.0
            geo_n = jnp.where(flip, -geo_n, geo_n)
            wt3 = maths.normalize(maths.matvec(nmat, lt[..., :3]))
            wt = jnp.concatenate([wt3, lt[..., 3:4]], axis=-1)
        if mrow is not None:
            # material row rides attr_rows — gather-free surface point
            mp = shade.material_point_from_row(mrow, uv, sc.textures)
            n = shade.apply_normal_map(
                sc.materials, mat_id, geo_n, wt, uv, sc.textures,
                nrm_tex_id=mrow[..., 13].astype(jnp.int32))
        else:
            mp = shade.get_material_point(sc.materials, mat_id, uv,
                                          sc.textures)
            n = shade.apply_normal_map(sc.materials, mat_id, geo_n, wt,
                                       uv, sc.textures)

        view = -d
        light_on = bool(flags & RenderFlags.LIGHT)
        sun_dir = maths.normalize(-params.sun_direction)
        sun_int = params.sun_color * params.sun_intensity if light_on else \
            jnp.zeros((3,), jnp.float32)

        shadow_origin = sampling.offset_ray(world_pos, geo_n)
        # occlusion gating ladder (SHADE_OCC_GATE): "0" = none, "1" =
        # facing gates (default), "lum" = facing + skip
        # occlusion rays whose UNSHADOWED contribution luminance is
        # below OCC_LUM_EPS (default 2e-3 linear HDR) — the BRDF·light
        # product is computed anyway, so the gate is free; skipped rays
        # contribute 0 (bias bounded by the threshold per sample).
        gate_mode = os.environ.get("SHADE_OCC_GATE", "1")
        gate = gate_mode != "0"
        lum_gate = gate_mode == "lum"
        lum_eps = float(os.environ.get("OCC_LUM_EPS", "2e-3"))

        def _lum(rgb):
            return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
                    + 0.0722 * rgb[..., 2])

        sun_brdf = shade.eval_pbr(mp.colour, 1.5, mp.roughness,
                                  mp.metallic, n, view, sun_dir) * sun_int
        sun_act = None
        if light_on:
            # hits facing away from the sun get zero BRDF — skip their
            # occlusion traversal (inactive rays return shadow=0, same
            # final contribution, no traversal steps)
            sun_facing = maths.dot(geo_n, jnp.broadcast_to(
                sun_dir, d.shape)) > 0.0 if gate else \
                jnp.ones(d.shape[:-1], bool)
            if lum_gate:
                sun_facing = sun_facing & (_lum(sun_brdf) > lum_eps)
            sun_act = sun_facing if active is None else \
                (sun_facing & active)

        # emissive area-light NEE setup (closesthit.rchit:82-96)
        nee_act = None
        if sc.lights.count > 0 and stage != "nonee":
            R = o.shape[0]
            idx = jnp.arange(R, dtype=jnp.uint32) if ray_idx is None \
                else ray_idx
            seed = sampling.init_random_seed(idx, params.frame_index)
            ldir, sampled_inst, seed = sampling.sample_lights(
                sc, world_pos, seed)
            has = maths.length(ldir) > 0.001
            if gate:
                has = has & (maths.dot(geo_n, ldir) > 0.0)
            s_inst = jnp.maximum(sampled_inst, 0)
            # per-instance emission joined at N-table size so the sampled
            # light costs ONE per-ray gather instead of two chained ones
            inst_emission = sc.materials.emission[sc.instances.material] \
                * 5.0
            # sampled instances are near-uniform in few-light scenes —
            # spread the tiny-table gather (texture.spread_gather, r5)
            l_rad = texture.spread_gather(inst_emission, s_inst)
            nee = shade.eval_pbr(mp.colour, 1.5, mp.roughness, mp.metallic,
                                 n, view, ldir) * l_rad
            if lum_gate:
                has = has & (_lum(nee) > lum_eps)
            nee_act = has if active is None else (has & active)

        # occlusion dispatches: the sun and NEE queries share origins —
        # fuse them into ONE any-hit traversal (2R rays) when both are
        # live, halving the per-dispatch overhead of every radiance
        # pass. Per-ray results are dispatch-layout-independent, so the
        # fused call is exact.
        sun_shadow = jnp.zeros(d.shape[:-1], jnp.float32)
        lshadow = None
        sun_dirs = jnp.broadcast_to(sun_dir, d.shape)
        if skip_occlusion:
            if sun_act is not None:
                sun_shadow = sun_act.astype(jnp.float32)
            if nee_act is not None:
                lshadow = nee_act.astype(jnp.float32)
        elif sun_act is not None and nee_act is not None \
                and os.environ.get("SHADE_OCC_FUSE", "1") != "0":
            both = self.occluded(
                sc, jnp.concatenate([shadow_origin, shadow_origin]),
                jnp.concatenate([sun_dirs, ldir]), 1000.0,
                active=jnp.concatenate([sun_act, nee_act]))
            sun_shadow, lshadow = both[:d.shape[0]], both[d.shape[0]:]
        else:
            if sun_act is not None:
                sun_shadow = self.occluded(sc, shadow_origin, sun_dirs,
                                           1000.0, active=sun_act)
            if nee_act is not None:
                lshadow = self.occluded(sc, shadow_origin, ldir, 1000.0,
                                        active=nee_act)
        direct = sun_brdf * sun_shadow[..., None]
        if nee_act is not None:
            ok = (has & (lshadow > 0.5) & (sampled_inst >= 0))[..., None]
            direct = direct + jnp.where(ok, nee, 0.0)

        # IBL ambient (closesthit.rchit:99-113)
        ambient = jnp.zeros_like(direct)
        if flags & RenderFlags.IBL:
            r = maths.reflect(d, n)
            env_spec = sky.sample_environment(r, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            env_diff = sky.sample_environment(n, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            f0 = maths.mix(jnp.full_like(mp.colour, 0.04), mp.colour,
                           mp.metallic[..., None])
            f = shade.fresnel_schlick(f0, n, view)
            kd = (1.0 - f) * (1.0 - mp.metallic[..., None])
            amb_str = jnp.maximum(params.ambient_strength, 0.2)
            ambient = (kd * env_diff * mp.colour + f * env_spec) * amb_str

        return direct + ambient + mp.emission


_pack = jax.jit(trace_cuda.pack_nodes)
