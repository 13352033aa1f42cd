"""Host-side Scene: entities + models → flattened device SceneData.

Counterpart of Scene (Scene.cpp:46-440) + the flattening done
by ResourceManager::SyncInstancesToGPU (ResourceManager.cpp:477-532): each
entity×mesh becomes one InstanceTable row (the ObjectID /
instanceCustomIndex contract), vertex/index data concatenates into global
pools, and the world-space triangle soup replaces the TLAS/BLAS build
(Scene.cpp:323-440, Model.cpp:114-186) as input for the LBVH.

Culling: the reference's octree (Scene.cpp:214-308) exists to make CPU
frustum culling sub-linear. On the device, frustum-vs-AABB over *all* instances
is one fused vectorized op (core/maths.aabb_outside_frustum), so the
octree is intentionally replaced by a dense test — same contract
(conservative, never culls visible), better hardware fit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.types import INVALID_ID
from . import geometry
from .schema import (
    InstanceTable,
    LightTable,
    Material,
    MaterialTable,
    SceneData,
    SunLight,
    build_attr_rows,
    build_inst_shade,
    build_shade_rows,
    build_shade_rows_q,
    TextureStack,
    TriangleSoup,
    VertexArrays,
)


@dataclasses.dataclass
class Entity:
    """Scene entity: a model (list of mesh ids) + transform (SceneCommon.h:252-278)."""

    mesh_ids: List[int]
    transform: np.ndarray
    prev_transform: Optional[np.ndarray] = None
    name: str = "entity"


class Scene:
    """Mutable host scene; ``build()`` produces the immutable device pytree."""

    def __init__(self, name: str = "scene"):
        self.name = name
        self.materials: List[Material] = []
        self.meshes: List[geometry.MeshData] = []
        self.entities: List[Entity] = []
        self.sun = SunLight.default()
        self.sky_texture: int = INVALID_ID
        self.textures: Optional[TextureStack] = None
        # bake the one-gather quad-texel layout at build (4x texture
        # memory; disable for very large texture sets)
        self.texture_quads: bool = True
        self._blue_noise_seed = 7

    # --- building blocks -------------------------------------------------
    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_mesh(self, mesh: geometry.MeshData) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_entity(self, mesh_ids, transform=None, prev_transform=None,
                   name="entity") -> int:
        if isinstance(mesh_ids, int):
            mesh_ids = [mesh_ids]
        t = np.eye(4, dtype=np.float32) if transform is None else \
            np.asarray(transform, np.float32)
        self.entities.append(Entity(list(mesh_ids), t, prev_transform, name))
        return len(self.entities) - 1

    def add_model(self, meshes_with_transforms, name="model"):
        """Convenience: [(MeshData, transform)] → entities."""
        for mesh, t in meshes_with_transforms:
            mid = self.add_mesh(mesh)
            self.add_entity(mid, t, name=name)

    def set_sun(self, direction, color=(1.0, 1.0, 1.0), intensity=3.0,
                ambient=0.05):
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        self.sun = SunLight(
            direction=jnp.asarray(d),
            color=jnp.asarray(color, jnp.float32),
            intensity=jnp.float32(intensity),
            ambient=jnp.float32(ambient),
        )

    # --- flatten ---------------------------------------------------------
    def build(self) -> SceneData:
        if not self.materials:
            self.materials = [Material()]

        # Global vertex/index pools (Model.cpp:24-112 upload analog).
        v_pos, v_nrm, v_tan, v_uv = [], [], [], []
        mesh_voffset, mesh_ioffset, mesh_icount = [], [], []
        all_indices = []
        voff = 0
        for mesh in self.meshes:
            mesh_voffset.append(voff)
            mesh_ioffset.append(sum(len(i) for i in all_indices))
            mesh_icount.append(len(mesh.indices))
            v_pos.append(mesh.positions)
            v_nrm.append(mesh.normals)
            v_tan.append(mesh.tangents)
            v_uv.append(mesh.uvs)
            all_indices.append(mesh.indices.astype(np.int32) + voff)
            voff += mesh.num_vertices

        positions = np.concatenate(v_pos) if v_pos else np.zeros((0, 3), np.float32)
        normals = np.concatenate(v_nrm) if v_nrm else np.zeros((0, 3), np.float32)
        tangents = np.concatenate(v_tan) if v_tan else np.zeros((0, 4), np.float32)
        uvs = np.concatenate(v_uv) if v_uv else np.zeros((0, 2), np.float32)
        indices = np.concatenate(all_indices) if all_indices else np.zeros((0,), np.int32)

        # Instances: entity × mesh flatten (ResourceManager.cpp:477-532).
        rows = []
        for ent in self.entities:
            prev = ent.prev_transform if ent.prev_transform is not None else ent.transform
            for mid in ent.mesh_ids:
                rows.append((mid, ent.transform, np.asarray(prev, np.float32)))

        n = len(rows)
        tf = np.stack([r[1] for r in rows]) if n else np.zeros((0, 4, 4), np.float32)
        ptf = np.stack([r[2] for r in rows]) if n else np.zeros((0, 4, 4), np.float32)
        inv = np.linalg.inv(tf) if n else tf
        nrm_tf = np.transpose(np.linalg.inv(tf[:, :3, :3]), (0, 2, 1)) if n else \
            np.zeros((0, 3, 3), np.float32)
        nrm4 = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        if n:
            nrm4[:, :3, :3] = nrm_tf

        amin = np.zeros((n, 3), np.float32)
        amax = np.zeros((n, 3), np.float32)
        mat_ids = np.zeros((n,), np.int32)
        voffs = np.zeros((n,), np.int32)
        ioffs = np.zeros((n,), np.int32)
        icnts = np.zeros((n,), np.int32)
        tri_inst, tri_i0, tri_i1, tri_i2 = [], [], [], []
        for i, (mid, t, _) in enumerate(rows):
            mesh = self.meshes[mid]
            lo, hi = mesh.local_aabb()
            corners = np.array(np.meshgrid(*zip(lo, hi))).T.reshape(-1, 3)
            wc = corners @ t[:3, :3].T + t[:3, 3]
            amin[i], amax[i] = wc.min(axis=0), wc.max(axis=0)
            mat_ids[i] = mesh.material
            voffs[i] = mesh_voffset[mid]
            ioffs[i] = mesh_ioffset[mid]
            icnts[i] = mesh_icount[mid]
            gi = mesh.indices.astype(np.int32).reshape(-1, 3) + mesh_voffset[mid]
            tri_i0.append(gi[:, 0]); tri_i1.append(gi[:, 1]); tri_i2.append(gi[:, 2])
            tri_inst.append(np.full((len(gi),), i, np.int32))

        instances = InstanceTable(
            transform=jnp.asarray(tf),
            inverse_transform=jnp.asarray(inv.astype(np.float32)),
            normal_transform=jnp.asarray(nrm4),
            prev_transform=jnp.asarray(ptf),
            aabb_min=jnp.asarray(amin),
            aabb_max=jnp.asarray(amax),
            material=jnp.asarray(mat_ids),
            vertex_offset=jnp.asarray(voffs),
            index_offset=jnp.asarray(ioffs),
            index_count=jnp.asarray(icnts),
            selected=jnp.zeros((n,), jnp.int32),
        )

        # World-space triangle soup (TLAS replacement). Static scenes bake
        # world positions once; dynamic scenes re-run world_triangles().
        i0 = np.concatenate(tri_i0) if tri_i0 else np.zeros((0,), np.int32)
        i1 = np.concatenate(tri_i1) if tri_i1 else np.zeros((0,), np.int32)
        i2 = np.concatenate(tri_i2) if tri_i2 else np.zeros((0,), np.int32)
        t_inst = np.concatenate(tri_inst) if tri_inst else np.zeros((0,), np.int32)
        pw = _world_positions(positions, tf, rows, mesh_voffset, self.meshes)
        m_alpha = np.array([m.alpha_mode for m in self.materials], np.int32)
        m_ds = np.array([bool(m.double_sided) for m in self.materials])
        tri_mat = mat_ids[t_inst] if len(t_inst) else t_inst
        single = (~m_ds[tri_mat]) & (m_alpha[tri_mat] == 0) \
            if len(t_inst) else np.zeros((0,), bool)
        soup = TriangleSoup(
            v0=jnp.asarray(pw[i0]), v1=jnp.asarray(pw[i1]), v2=jnp.asarray(pw[i2]),
            instance=jnp.asarray(t_inst),
            i0=jnp.asarray(i0), i1=jnp.asarray(i1), i2=jnp.asarray(i2),
            single_sided=jnp.asarray(single),
        )

        lights = build_light_table(self, rows, pw, i0, i1, i2, t_inst)

        # stash flatten internals for dynamic-update map building
        # (scene/dynamic.build_maps) — host-only, not part of the pytree
        self._built = dict(rows=rows, mesh_voffset=mesh_voffset,
                           i0=i0, i1=i1, i2=i2, t_inst=t_inst)

        vertices = VertexArrays(
            position=jnp.asarray(positions),
            world_position=jnp.asarray(pw),
            normal=jnp.asarray(normals),
            tangent=jnp.asarray(tangents), uv=jnp.asarray(uvs),
        )
        materials = MaterialTable.build(self.materials)
        return SceneData(
            materials=materials,
            instances=instances,
            vertices=vertices,
            indices=jnp.asarray(indices),
            triangles=soup,
            lights=lights,
            textures=(self.textures if self.textures is not None
                      else TextureStack.empty()).finalized(
                          self.materials, bake_quads=self.texture_quads),
            sun=self.sun,
            sky_texture=jnp.int32(self.sky_texture),
            blue_noise=_generate_blue_noise(64, self._blue_noise_seed),
            has_alpha_test=any(
                m.alpha_mode == 1 and m.colour_texture >= 0
                for m in self.materials),
            has_sky_texture=self.sky_texture != INVALID_ID,
            attr_rows=(attr := build_attr_rows(vertices, instances, soup,
                                               materials)),
            shade_rows=(srows := build_shade_rows(attr)),
            # quantized narrow table only when the exact one can't ride
            # the fast-gather byte gate (Sponza-scale scenes)
            shade_rows_q=(qrows := None if srows is not None else
                          build_shade_rows_q(vertices, instances, soup)),
            inst_shade=build_inst_shade(instances, materials)
            if qrows is not None else None,
        )


def _world_positions(positions, tf, rows, mesh_voffset, meshes):
    """Per-instance world-space copies of each instance's vertex range.

    Because instances may share a mesh, world positions are stored per the
    *first* instance that references each vertex range; for the common
    unique-mesh-per-entity case (the reference's importer does the same
    world-space bake, AssetImporter.cpp:37-135) this is exact.
    """
    pw = positions.copy()
    seen = set()
    for i, (mid, t, _) in enumerate(rows):
        if mid in seen:
            continue
        seen.add(mid)
        lo = mesh_voffset[mid]
        hi = lo + meshes[mid].num_vertices
        pw[lo:hi] = positions[lo:hi] @ t[:3, :3].T + t[:3, 3]
    return pw


def build_light_table(scene: Scene, rows, pw, i0, i1, i2, t_inst) -> LightTable:
    """Emissive-triangle CDF build (LightManager.cpp:21-124).

    For every instance whose material has ||emission|| > 1e-3, emit a
    GpuLight row with a prefix-sum of world-space triangle areas.
    """
    lights_inst, cdf_start, cdf_count, env = [], [], [], []
    cdf_all = []
    for inst_id, (mid, _, _) in enumerate(rows):
        mesh = scene.meshes[mid]
        mat = scene.materials[mesh.material]
        if np.linalg.norm(np.asarray(mat.emission)) < 1e-3:
            continue
        mask = t_inst == inst_id
        a, b, c = pw[i0[mask]], pw[i1[mask]], pw[i2[mask]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        if len(areas) == 0:
            continue
        lights_inst.append(inst_id)
        cdf_start.append(sum(len(x) for x in cdf_all))
        cdf_count.append(len(areas))
        env.append(INVALID_ID)
        cdf_all.append(np.cumsum(areas).astype(np.float32))
    if scene.sky_texture != INVALID_ID:
        lights_inst.append(INVALID_ID)
        cdf_start.append(sum(len(x) for x in cdf_all))
        cdf_count.append(0)
        env.append(int(scene.sky_texture))
    if not lights_inst:
        return LightTable.empty()
    cdf = np.concatenate(cdf_all) if cdf_all else np.zeros((1,), np.float32)
    return LightTable(
        instance=jnp.asarray(np.array(lights_inst, np.int32)),
        cdf_start=jnp.asarray(np.array(cdf_start, np.int32)),
        cdf_count=jnp.asarray(np.array(cdf_count, np.int32)),
        environment=jnp.asarray(np.array(env, np.int32)),
        cdf=jnp.asarray(cdf),
    )


def _generate_blue_noise(size: int, seed: int):
    """Procedural noise texture (ResourceManager::GenerateBlueNoise
    fallback, ResourceManager.cpp:921-965). High-pass-filtered white noise
    approximates blue-noise spectral properties well enough for sampling.
    """
    rng = np.random.default_rng(seed)
    white = rng.random((size, size, 4)).astype(np.float32)
    # Simple spectral shaping: subtract a small blur, renormalize to [0,1).
    blur = np.zeros_like(white)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            blur += np.roll(np.roll(white, dy, 0), dx, 1)
    blur /= 9.0
    shaped = white - 0.5 * (blur - 0.5)
    ranks = shaped.reshape(-1, 4).argsort(axis=0).argsort(axis=0)
    out = (ranks.astype(np.float32) + 0.5) / (size * size)
    return jnp.asarray(out.reshape(size, size, 4))


# --- canned scenes (test/bench fixtures; BASELINE.json configs) ---------

def cube_scene() -> Scene:
    """Config 1: single cube + ground plane, one directional sun."""
    sc = Scene("cube")
    m_floor = sc.add_material(Material(name="floor", colour=(0.6, 0.6, 0.6),
                                       roughness=0.9))
    m_cube = sc.add_material(Material(name="red", colour=(0.8, 0.15, 0.1),
                                      roughness=0.4, metallic=0.1))
    floor = geometry.plane(size=20.0, material=m_floor)
    box = geometry.cube(size=1.5, material=m_cube)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.0, 0.75, 0.0]
    sc.add_entity(sc.add_mesh(floor), name="floor")
    sc.add_entity(sc.add_mesh(box), t, name="cube")
    sc.set_sun((-1.0, -1.0, -0.5), intensity=3.0)
    return sc


def cornell_scene() -> Scene:
    """Cornell-style box with an emissive ceiling quad — exercises NEE
    light sampling + GI."""
    sc = Scene("cornell")
    # box walls are open quads (visible from outside in some shots):
    # two-sided like the reference G-buffer's CULL_NONE
    white = sc.add_material(Material(name="white", colour=(0.73, 0.73, 0.73), roughness=0.9,
                                     double_sided=True))
    red = sc.add_material(Material(name="red", colour=(0.65, 0.05, 0.05), roughness=0.9,
                                   double_sided=True))
    green = sc.add_material(Material(name="green", colour=(0.12, 0.45, 0.15), roughness=0.9,
                                     double_sided=True))
    lightm = sc.add_material(Material(name="light", colour=(1, 1, 1),
                                      emission=(15.0, 15.0, 15.0),
                                      double_sided=True))
    metal = sc.add_material(Material(name="metal", colour=(0.8, 0.8, 0.9),
                                     roughness=0.1, metallic=1.0))
    s = 5.0
    sc.add_entity(sc.add_mesh(geometry.quad_facing((0, 1, 0), (0, 0, 0), s * 2, white)))
    sc.add_entity(sc.add_mesh(geometry.quad_facing((0, -1, 0), (0, s, 0), s * 2, white)))
    sc.add_entity(sc.add_mesh(geometry.quad_facing((0, 0, 1), (0, s / 2, -s / 2), s * 2, white)))
    sc.add_entity(sc.add_mesh(geometry.quad_facing((1, 0, 0), (-s / 2, s / 2, 0), s * 2, red)))
    sc.add_entity(sc.add_mesh(geometry.quad_facing((-1, 0, 0), (s / 2, s / 2, 0), s * 2, green)))
    sc.add_entity(sc.add_mesh(geometry.quad_facing((0, -1, 0), (0, s - 0.01, 0), 1.5, lightm)))
    t = np.eye(4, dtype=np.float32); t[:3, 3] = [-1.0, 0.75, -0.5]
    sc.add_entity(sc.add_mesh(geometry.cube(1.5, white)), t)
    t2 = np.eye(4, dtype=np.float32); t2[:3, 3] = [1.2, 0.6, 0.8]
    sc.add_entity(sc.add_mesh(geometry.uv_sphere(0.6, material=metal)), t2)
    sc.set_sun((-0.3, -1.0, -0.2), intensity=0.0)  # interior: area light only
    return sc


def cutout_scene() -> Scene:
    """Alpha-tested (cut-out) foliage-style quads over a ground plane —
    exercises gbuffer discard (gbuffer.frag:33) + transparent any-hit
    skipping (shadow.rahit, common.glsl:139-148)."""
    sc = Scene("cutout")
    ground = sc.add_material(Material(name="ground", colour=(0.6, 0.6, 0.6),
                                      roughness=0.9))
    leaf = sc.add_material(Material(name="leaf", colour=(0.25, 0.7, 0.25),
                                    roughness=0.8, colour_texture=0,
                                    alpha_mode=1, alpha_cutoff=0.5))
    sc.add_entity(sc.add_mesh(geometry.plane(size=16.0, material=ground)))
    for (cx, cz, ang) in ((-2.0, 0.0, 0.3), (1.5, 1.0, -0.6),
                          (0.0, -2.0, 1.2)):
        t = np.eye(4, dtype=np.float32)
        c, s_ = np.cos(ang), np.sin(ang)
        t[:3, :3] = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, 1 * c]],
                             np.float32)
        t[:3, 3] = [cx, 1.6, cz]
        sc.add_entity(sc.add_mesh(
            geometry.quad_facing((0, 0, 1), (0, 0, 0), 3.0, material=leaf)), t)
    # alpha texture: soft radial blob mask with holes
    n = 64
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1.0)
    blobs = np.zeros((n, n), np.float32)
    for (bx, by, r) in ((0.3, 0.3, 0.18), (0.7, 0.35, 0.15),
                        (0.5, 0.7, 0.22), (0.25, 0.75, 0.12)):
        blobs = np.maximum(
            blobs, (np.hypot(xx - bx, yy - by) < r).astype(np.float32))
    data = np.ones((1, n, n, 4), np.float32)
    data[0, ..., 3] = blobs
    sc.textures = TextureStack(data=jnp.asarray(data),
                               sizes=jnp.asarray([[n, n]], np.int32))
    sc.set_sun((-0.4, -1.0, -0.3), intensity=3.0, ambient=0.25)
    return sc


def stress_scene(num_objects=400, seed=0, textured=False,
                 tex_size=128) -> Scene:
    """Sponza-scale stress scene for benchmarking (~10^5 triangles).

    ``textured=True`` binds procedural albedo textures to every material
    (a 4-texture atlas) so the G-buffer material fetch and any textured
    shading exercise the bilinear sampler — the texture-gather cost axis
    the plain scene never touches."""
    sc = Scene("stress")
    tex = (lambda i: i) if textured else (lambda i: INVALID_ID)
    sc.add_material(Material(name="floor", colour=(0.55, 0.5, 0.45),
                             roughness=0.8, colour_texture=tex(0)))
    sc.add_material(Material(name="column", colour=(0.7, 0.68, 0.6),
                             roughness=0.6, colour_texture=tex(1)))
    sc.add_material(Material(name="sphere", colour=(0.3, 0.4, 0.7),
                             roughness=0.3, metallic=0.4,
                             colour_texture=tex(2)))
    sc.add_material(Material(name="box", colour=(0.7, 0.3, 0.2),
                             roughness=0.5, colour_texture=tex(3)))
    sc.add_model(geometry.stress_scene_meshes(num_objects, seed))
    if textured:
        # tex_size: the texture-fidelity axis — the
        # same four procedural patterns at 128..2048 texels measure the
        # high-res sampling cost envelope without a bundled asset
        n = tex_size
        yy, xx = np.mgrid[0:n, 0:n] / (n - 1.0)
        pats = [
            ((yy * 8).astype(int) + (xx * 8).astype(int)) % 2 * 0.6 + 0.3,
            (np.sin(yy * 40) * 0.5 + 0.5) * 0.7 + 0.2,
            (np.hypot(xx - 0.5, yy - 0.5) * 2.0) % 1.0,
            ((yy * 16).astype(int) % 2) * 0.5 + 0.4,
        ]
        tex_data = np.ones((4, n, n, 4), np.float32)
        for i, p in enumerate(pats):
            tex_data[i, ..., 0] = p
            tex_data[i, ..., 1] = p * 0.8 + 0.1
            tex_data[i, ..., 2] = 1.0 - p * 0.5
        sc.textures = TextureStack(
            data=jnp.asarray(tex_data),
            sizes=jnp.asarray(np.full((4, 2), n, np.int32)))
    sc.set_sun((-0.4, -1.0, -0.3), intensity=3.0)
    return sc
