"""Deferred G-buffer construction from the visibility buffer.

Computes exactly the reference's MRT planes (gbuffer.frag:25-67):
  albedo rgb (+ ∂lin-z/∂y), world normal, material params
  (roughness², metallic, ao, type/255), ObjectID, motion
  (uv-motion, linear depth, ∂lin-z/∂x), emissive, reversed-Z depth.

Where the reference's fragment shader gets attributes from the raster
interpolators and gradients from dFdx/dFdy, we gather vertex data with
the visibility buffer's perspective-correct barycentrics and take
neighbor differences of the linear-depth image — the deferred analog.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax
import jax.numpy as jnp

from ..core import maths
from . import shade
from .raster import VisibilityBuffer


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GBuffer:
    albedo: Any          # (H, W, 3)
    normal: Any          # (H, W, 3) world space
    material: Any        # (H, W, 4) roughness², metallic, ao, type/255
    object_id: Any       # (H, W) i32, -1 background
    motion: Any          # (H, W, 2) uv-space motion (cur - prev)
    linear_depth: Any    # (H, W) view-space |z|
    depth_grad: Any      # (H, W, 2) (∂lin-z/∂x, ∂lin-z/∂y)
    emissive: Any        # (H, W, 3)
    depth: Any           # (H, W) reversed-Z NDC
    world_pos: Any       # (H, W, 3)
    uv: Any              # (H, W, 2) surface uv (for debug/alpha passes)

    @property
    def background(self):
        return self.object_id < 0

    def motion_plane(self):
        """The reference's Motion RT layout: (motion.xy, linZ, dzdx)."""
        return jnp.concatenate(
            [self.motion, self.linear_depth[..., None],
             self.depth_grad[..., 0:1]], axis=-1)


def linearize_depth(depth, proj_inverse):
    """gbuffer.frag LinearizeDepth: |(P⁻¹·(0,0,d,1)).z / w|."""
    z = proj_inverse[2, 2] * depth + proj_inverse[2, 3]
    w = proj_inverse[3, 2] * depth + proj_inverse[3, 3]
    return jnp.abs(z / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w))


def screen_gradients(img):
    """dFdx/dFdy analog: forward difference clamped at borders."""
    dx = jnp.diff(img, axis=1, append=img[:, -1:])
    dy = jnp.diff(img, axis=0, append=img[-1:, :])
    return dx, dy


def cutout_alpha_pass(vis: VisibilityBuffer, scene):
    """Alpha test of the cut-out raster layer's winning texels
    (gbuffer.frag:33 `discard`, deferred): True where the pixel's
    triangle samples alpha >= cutoff."""
    from . import texture

    soup = scene.triangles
    tri = jnp.maximum(vis.tri_id, 0)
    b1 = vis.bary1[..., None]
    b2 = vis.bary2[..., None]
    # one wide gather per pixel from the pre-joined attribute rows
    # (vs six narrow 2M-row gathers; see build_gbuffer's rationale)
    if scene.attr_rows is not None:
        row = scene.attr_rows[tri]
        uv = row[..., 13:15] * (1.0 - b1 - b2) + row[..., 28:30] * b1 \
            + row[..., 43:45] * b2
        tex = row[..., 77].astype(jnp.int32)    # colour texture id
        cutoff = row[..., 82]                    # alpha cutoff
    else:
        uvs = scene.vertices.uv
        tpk = jnp.concatenate([
            uvs[soup.i0], uvs[soup.i1], uvs[soup.i2],
            scene.instances.material[soup.instance][:, None].astype(
                jnp.float32),
        ], axis=-1)
        row = tpk[tri]
        uv = row[..., 0:2] * (1.0 - b1 - b2) + row[..., 2:4] * b1 \
            + row[..., 4:6] * b2
        mat = row[..., 6].astype(jnp.int32)
        tex = scene.materials.colour_texture[mat]
        cutoff = scene.materials.alpha_cutoff[mat]
    rgba = texture.sample_stack(
        scene.textures, tex, uv, jnp.ones((4,), jnp.float32))
    return rgba[..., 3] >= cutoff


def build_gbuffer(vis: VisibilityBuffer, scene, cam) -> GBuffer:
    """Visibility buffer + scene + camera → full G-buffer."""
    H, W = vis.depth.shape
    tri = jnp.maximum(vis.tri_id, 0)
    bg = vis.tri_id < 0
    b1, b2 = vis.bary1, vis.bary2
    b0 = 1.0 - b1 - b2

    # Everything a pixel needs lives in ONE pre-joined per-triangle row
    # (scene.attr_rows, built once at scene build / transform update),
    # so each pixel costs a single wide gather instead of five narrow
    # 2M-row gathers. "pixel" stays as an env override for A/B probes.
    soup = scene.triangles
    fetch = os.environ.get("GBUFFER_FETCH", "auto")
    mrow = None
    if fetch != "pixel" and scene.attr_rows is not None:
        row = scene.attr_rows[tri]                     # ONE gather
        r0 = row[..., 0:15]
        r1 = row[..., 15:30]
        r2 = row[..., 30:45]
        irow = row[..., 45:67]
        mrow = row[..., 67:83]                         # packed material
        inst_id = row[..., 83].astype(jnp.int32)
    else:
        verts = scene.vertices
        vpack = jnp.concatenate([
            verts.world_position,          # 0:3
            verts.position,                # 3:6
            verts.normal,                  # 6:9
            verts.tangent,                 # 9:13
            verts.uv,                      # 13:15
        ], axis=-1)                        # (V, 15)
        N = scene.instances.count
        ipack = jnp.concatenate([
            scene.instances.normal_transform[:, :3, :3].reshape(N, 9),
            scene.instances.prev_transform[:, :3, :4].reshape(N, 12),
            scene.instances.material[:, None].astype(jnp.float32),
        ], axis=-1)                        # (N, 22)
        tpack = jnp.concatenate([
            soup.instance[:, None].astype(jnp.float32),
            soup.i0[:, None].astype(jnp.float32),
            soup.i1[:, None].astype(jnp.float32),
            soup.i2[:, None].astype(jnp.float32),
        ], axis=-1)                    # (T, 4)
        trow = tpack[tri]                              # one gather
        inst_id = trow[..., 0].astype(jnp.int32)
        i0 = trow[..., 1].astype(jnp.int32)
        i1 = trow[..., 2].astype(jnp.int32)
        i2 = trow[..., 3].astype(jnp.int32)
        r0 = vpack[i0]                                 # three gathers
        r1 = vpack[i1]
        r2 = vpack[i2]
        irow = ipack[inst_id]                          # one gather

    lerp = r0 * b0[..., None] + r1 * b1[..., None] + r2 * b2[..., None]

    world_pos = lerp[..., 0:3]
    local_pos = lerp[..., 3:6]
    local_n = lerp[..., 6:9]
    local_t = lerp[..., 9:13]
    uv = lerp[..., 13:15]
    nmat = irow[..., 0:9].reshape(*inst_id.shape, 3, 3)
    prev_tf34 = irow[..., 9:21].reshape(*inst_id.shape, 3, 4)
    mat_id = irow[..., 21].astype(jnp.int32)

    world_n = maths.normalize(maths.matvec(nmat, local_n))
    world_t3 = maths.normalize(maths.matvec(nmat, local_t[..., :3]))
    world_t = jnp.concatenate([world_t3, local_t[..., 3:4]], axis=-1)
    prev_world = maths.matvec(prev_tf34[..., :3, :3], local_pos) \
        + prev_tf34[..., :3, 3]

    # material point + normal mapping (material row rides attr_rows —
    # no extra per-pixel gather on the joined path)
    if mrow is not None:
        mp = shade.material_point_from_row(mrow, uv, scene.textures)
        shading_n = shade.apply_normal_map(
            scene.materials, mat_id, world_n, world_t, uv, scene.textures,
            nrm_tex_id=mrow[..., 13].astype(jnp.int32))
    else:
        mp = shade.get_material_point(scene.materials, mat_id, uv,
                                      scene.textures)
        shading_n = shade.apply_normal_map(
            scene.materials, mat_id, world_n, world_t, uv, scene.textures)

    return _finish_gbuffer(vis, cam, bg, H, W, world_pos, prev_world,
                           uv, inst_id, mp, shading_n)


def _finish_gbuffer(vis, cam, bg, H, W, world_pos, prev_world, uv,
                    inst_id, mp, shading_n) -> GBuffer:
    # motion vectors (gbuffer.frag:56-63): unjittered cur/prev clip pos
    vp = maths.mm(jnp.asarray(cam.proj), jnp.asarray(cam.view))
    prev_vp = maths.mm(jnp.asarray(cam.prev_proj), jnp.asarray(cam.prev_view))
    cur_clip = maths.transform_point_h(vp, world_pos)
    prev_clip = maths.transform_point_h(prev_vp, prev_world)

    def to_uv(clip):
        w = clip[..., 3]
        w = jnp.where(jnp.abs(w) < 1e-6, 1e-6, w)
        return clip[..., :2] / w[..., None] * 0.5 + 0.5

    motion = to_uv(cur_clip) - to_uv(prev_clip)

    lin_depth = linearize_depth(vis.depth, cam.proj_inverse)
    lin_depth = jnp.where(bg, 0.0, lin_depth)
    dzdx, dzdy = screen_gradients(lin_depth)

    z3 = jnp.zeros((H, W, 3), jnp.float32)
    shading_model = mp.material_type.astype(jnp.float32) / 255.0
    material_plane = jnp.stack(
        [mp.roughness, mp.metallic, jnp.ones_like(mp.roughness), shading_model],
        axis=-1)

    mask3 = (~bg)[..., None]
    return GBuffer(
        albedo=jnp.where(mask3, mp.colour, z3),
        normal=jnp.where(mask3, shading_n, z3),
        material=jnp.where(mask3, material_plane, jnp.zeros_like(material_plane)),
        object_id=jnp.where(bg, -1, inst_id),
        motion=jnp.where(mask3[..., :2], motion, 0.0),
        linear_depth=lin_depth,
        depth_grad=jnp.where(mask3[..., :2], jnp.stack([dzdx, dzdy], -1), 0.0),
        emissive=jnp.where(mask3, mp.emission, z3),
        depth=vis.depth,
        world_pos=jnp.where(mask3, world_pos, z3),
        uv=jnp.where(mask3[..., :2], uv, 0.0),
    )
