"""Dynamic scene updates — per-frame entity-transform re-sync, on-device.

The reference re-syncs instance transforms and rebuilds the TLAS every
frame a transform is dirty (Scene.cpp:148-189 OnUpdate,
ResourceManager.cpp:477-532 SyncInstancesToGPU). Here the work splits:

  * ``build_maps(scene)`` — host, once per scene *topology*: static index
    maps (vertex→instance, per-instance local AABBs, light-CDF slots).
  * ``update_transforms(data, maps, transforms)`` — jitted: new instance
    matrices → new SceneData with recomputed inverse/normal transforms,
    world AABBs, world vertex positions, triangle soup and light CDF.
    prev_transform takes the old current transforms, so G-buffer motion
    vectors (ops/gbuffer.py) see real object motion.
  * acceleration refit is SceneTracer.refit (ops/trace.py) — frozen
    topology, device-only.

Entity-level convenience lives on DynamicScene.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import maths
from . import schema


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DynamicMaps:
    """Static per-topology index maps enabling jitted transform updates."""

    vertex_instance: Any   # (V,) i32 — owning (first) instance per vertex
    local_lo: Any          # (N, 3) f32 per-instance local-space AABB
    local_hi: Any          # (N, 3)
    instance_entity: Any   # (N,) i32 — entity id per instance row
    cdf_tri: Any           # (C,) i32 triangle id per light-CDF slot
    cdf_seg_start: Any     # (C,) i32 slot index of the segment start


def build_maps(scene) -> DynamicMaps:
    """Host-side map build; requires scene.build() to have run."""
    built = getattr(scene, "_built", None)
    if built is None:
        raise ValueError("scene.build() must run before build_maps()")
    rows = built["rows"]
    mesh_voffset = built["mesh_voffset"]

    total_v = sum(m.num_vertices for m in scene.meshes)
    vertex_instance = np.zeros((total_v,), np.int32)
    seen = set()
    for i, (mid, _t, _p) in enumerate(rows):
        if mid in seen:
            continue  # world bake uses the FIRST instance (scene.py
        seen.add(mid)  # _world_positions semantics)
        lo = mesh_voffset[mid]
        vertex_instance[lo:lo + scene.meshes[mid].num_vertices] = i

    n = len(rows)
    local_lo = np.zeros((n, 3), np.float32)
    local_hi = np.zeros((n, 3), np.float32)
    for i, (mid, _t, _p) in enumerate(rows):
        lo, hi = scene.meshes[mid].local_aabb()
        local_lo[i], local_hi[i] = lo, hi

    inst_ent = np.zeros((n,), np.int32)
    k = 0
    for eid, ent in enumerate(scene.entities):
        for _ in ent.mesh_ids:
            inst_ent[k] = eid
            k += 1

    # light-CDF slots (mirrors build_light_table's iteration order)
    t_inst = built["t_inst"]
    cdf_tri_l, seg_start_l = [], []
    for inst_id, (mid, _t, _p) in enumerate(rows):
        mesh = scene.meshes[mid]
        mat = scene.materials[mesh.material]
        if np.linalg.norm(np.asarray(mat.emission)) < 1e-3:
            continue
        tri_ids = np.flatnonzero(t_inst == inst_id)
        if len(tri_ids) == 0:
            continue
        off = sum(len(x) for x in cdf_tri_l)
        seg_start_l.append(np.full(len(tri_ids), off, np.int32))
        cdf_tri_l.append(tri_ids.astype(np.int32))
    if cdf_tri_l:
        cdf_tri = np.concatenate(cdf_tri_l)
        cdf_seg_start = np.concatenate(seg_start_l)
    else:
        cdf_tri = np.zeros((0,), np.int32)
        cdf_seg_start = np.zeros((0,), np.int32)

    return DynamicMaps(
        vertex_instance=jnp.asarray(vertex_instance),
        local_lo=jnp.asarray(local_lo), local_hi=jnp.asarray(local_hi),
        instance_entity=jnp.asarray(inst_ent),
        cdf_tri=jnp.asarray(cdf_tri),
        cdf_seg_start=jnp.asarray(cdf_seg_start))


def _update_instances(data, maps: DynamicMaps, transforms,
                      prev_transforms: Optional[Any] = None):
    """Full instance-table recompute (N is small — inverses, normal
    matrices and world AABBs for every instance)."""
    inst = data.instances
    prev = inst.transform if prev_transforms is None else prev_transforms
    tf = jnp.asarray(transforms, jnp.float32)

    inv = jnp.linalg.inv(tf)
    nrm3 = jnp.swapaxes(jnp.linalg.inv(tf[:, :3, :3]), 1, 2)
    n = tf.shape[0]
    nrm4 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))
    nrm4 = nrm4.at[:, :3, :3].set(nrm3)

    # world AABBs from the 8 local corners
    combos = np.array([[(c >> a) & 1 for a in range(3)]
                       for c in range(8)], np.float32)   # (8, 3) in {0,1}
    corners = (maps.local_lo[:, None, :] * (1.0 - combos[None])
               + maps.local_hi[:, None, :] * combos[None])   # (N, 8, 3)
    wc = jnp.einsum("nij,nkj->nki", tf[:, :3, :3], corners,
                    precision=maths.HIGHEST) \
        + tf[:, None, :3, 3]
    amin = wc.min(axis=1)
    amax = wc.max(axis=1)

    return tf, dataclasses.replace(
        inst, transform=tf, inverse_transform=inv.astype(jnp.float32),
        normal_transform=nrm4, prev_transform=prev,
        aabb_min=amin, aabb_max=amax)


def _update_light_cdf(data, maps: DynamicMaps, new_soup):
    lights = data.lights
    if maps.cdf_tri.shape[0] > 0 and lights.cdf.shape[0] == \
            maps.cdf_tri.shape[0]:
        a = new_soup.v0[maps.cdf_tri]
        b = new_soup.v1[maps.cdf_tri]
        c = new_soup.v2[maps.cdf_tri]
        areas = 0.5 * jnp.linalg.norm(jnp.cross(b - a, c - a), axis=-1)
        cs = jnp.cumsum(areas)
        base = jnp.where(maps.cdf_seg_start > 0,
                         cs[jnp.maximum(maps.cdf_seg_start - 1, 0)], 0.0)
        lights = dataclasses.replace(lights,
                                     cdf=(cs - base).astype(jnp.float32))
    return lights


@jax.jit
def update_transforms(data, maps: DynamicMaps, transforms,
                      prev_transforms: Optional[Any] = None):
    """New per-instance transforms → new SceneData, all on-device.

    ``transforms``: (N, 4, 4) world transforms in instance order.
    ``prev_transforms`` defaults to the data's current transforms (so the
    G-buffer motion math sees one frame of object motion).
    """
    tf, new_inst = _update_instances(data, maps, transforms,
                                     prev_transforms)

    # world vertex bake (first-instance semantics, scene._world_positions)
    vt = tf[maps.vertex_instance]
    pos = data.vertices.position
    pw = maths.matvec(vt[:, :3, :3], pos) + vt[:, :3, 3]
    new_verts = dataclasses.replace(data.vertices, world_position=pw)

    soup = data.triangles
    new_soup = dataclasses.replace(
        soup, v0=pw[soup.i0], v1=pw[soup.i1], v2=pw[soup.i2])

    lights = _update_light_cdf(data, maps, new_soup)

    # pre-joined attribute rows depend on world positions + instance
    # matrices — rebuild (4 T-row gathers, cheap next to the per-pixel
    # gathers they save; see schema.build_attr_rows)
    attr = None if data.attr_rows is None else schema.build_attr_rows(
        new_verts, new_inst, new_soup, data.materials)
    srows = None if data.shade_rows is None else \
        schema.encode_shade_rows(attr)
    # the quantized narrow table is transform-INVARIANT (local-space
    # columns only); just the KB-scale instance side table follows
    ishade = None if data.inst_shade is None else \
        schema.build_inst_shade(new_inst, data.materials)

    return dataclasses.replace(data, instances=new_inst,
                               vertices=new_verts, triangles=new_soup,
                               lights=lights, attr_rows=attr,
                               shade_rows=srows, inst_shade=ishade)


@functools.partial(jax.jit, static_argnames=("update_lights",))
def update_transforms_subset(data, maps: DynamicMaps, transforms,
                             vert_idx, tri_idx, update_lights=False,
                             prev_transforms: Optional[Any] = None):
    """Dirty-only transform update (Scene.cpp:148-189 re-syncs DIRTY
    instances only — the full re-bake of update_transforms costs ~T-row
    gathers per frame even for one moved entity).

    ``vert_idx`` (Dv,) / ``tri_idx`` (Dt,) are the dirty vertex/triangle
    row sets (host-computed by DynamicScene from the static topology
    maps, padded with row 0 — recomputing row 0 redundantly is
    idempotent). All gathers/scatters are row-count-priced, so a
    one-entity update touches ~1k rows instead of T. The instance table
    itself is recomputed in full (N is small). ``update_lights`` runs
    the full CDF rebake — host passes True only when a dirty instance
    is emissive."""
    tf, new_inst = _update_instances(data, maps, transforms,
                                     prev_transforms)

    vt = tf[maps.vertex_instance[vert_idx]]
    lp = data.vertices.position[vert_idx]
    rows = maths.matvec(vt[:, :3, :3], lp) + vt[:, :3, 3]
    pw = data.vertices.world_position.at[vert_idx].set(rows)
    new_verts = dataclasses.replace(data.vertices, world_position=pw)

    soup = data.triangles
    new_soup = dataclasses.replace(
        soup,
        v0=soup.v0.at[tri_idx].set(pw[soup.i0[tri_idx]]),
        v1=soup.v1.at[tri_idx].set(pw[soup.i1[tri_idx]]),
        v2=soup.v2.at[tri_idx].set(pw[soup.i2[tri_idx]]))

    lights = _update_light_cdf(data, maps, new_soup) if update_lights \
        else data.lights

    attr = data.attr_rows
    srows = data.shade_rows
    if attr is not None:
        new_rows = schema.build_attr_rows(
            new_verts, new_inst, new_soup, data.materials, tris=tri_idx)
        attr = attr.at[tri_idx].set(new_rows)
        if srows is not None:
            srows = srows.at[tri_idx].set(
                schema.encode_shade_rows(new_rows))
    ishade = None if data.inst_shade is None else \
        schema.build_inst_shade(new_inst, data.materials)

    return dataclasses.replace(data, instances=new_inst,
                               vertices=new_verts, triangles=new_soup,
                               lights=lights, attr_rows=attr,
                               shade_rows=srows, inst_shade=ishade)


def build_host_ranges(scene) -> dict:
    """Host-side static topology ranges for dirty-set scoping:
    per-instance triangle ranges, per-mesh vertex ranges + first
    instance, and per-instance emissive flags. Computed once per
    topology (numpy; never traced)."""
    built = scene._built
    rows, mesh_voffset = built["rows"], built["mesh_voffset"]
    t_inst = built["t_inst"]
    n = len(rows)
    tri_start = np.searchsorted(t_inst, np.arange(n))
    tri_end = np.searchsorted(t_inst, np.arange(n) + 1)
    inst_mesh = np.array([r[0] for r in rows], np.int32)
    first_inst = {}
    for i, (mid, _t, _p) in enumerate(rows):
        first_inst.setdefault(mid, i)
    emissive = np.array([
        np.linalg.norm(np.asarray(
            scene.materials[scene.meshes[mid].material].emission)) > 1e-3
        for mid in inst_mesh], bool)
    vstart = np.array(mesh_voffset, np.int32)
    vcount = np.array([m.num_vertices for m in scene.meshes], np.int32)
    return dict(tri_start=tri_start, tri_end=tri_end, inst_mesh=inst_mesh,
                first_inst=first_inst, emissive=emissive,
                vstart=vstart, vcount=vcount, n_tris=len(t_inst))


_PAD_QUANTUM = 4096  # dirty index arrays pad up to multiples of this so
#                      repeated same-entity commits reuse one trace


class DynamicScene:
    """Entity-level dynamic-update controller.

    Wraps a built host Scene + Renderer: set entity transforms, then
    ``commit()`` pushes one on-device update (instances, world geometry,
    light CDF) and refits the renderer's acceleration structure — the
    per-frame Scene::OnUpdate analog. Updates are scoped to the DIRTY
    entity set (Scene.cpp:148-189 re-syncs dirty instances only): the
    world bake / soup / attr-row scatters touch only the dirty rows;
    the full re-bake path runs when most of the scene moved.
    """

    def __init__(self, scene, renderer):
        self.scene = scene
        self.renderer = renderer
        self.maps = build_maps(scene)
        self.ranges = build_host_ranges(scene)
        rows = scene._built["rows"]
        self._transforms = np.stack([r[1] for r in rows]).astype(np.float32)
        self._dirty_entities = set()
        self._idx_cache = {}

    def set_entity_transform(self, entity_id: int, transform):
        ent_of = np.asarray(self.maps.instance_entity)
        m = np.asarray(transform, np.float32)
        self._transforms[ent_of == entity_id] = m
        self.scene.entities[entity_id].transform = m
        self._dirty_entities.add(int(entity_id))

    def _dirty_indices(self, key):
        """(vert_idx, tri_idx, update_lights) for the dirty entity set —
        cached: a turntable moving the same entity every frame reuses
        one pair of device arrays (and one jit trace)."""
        cached = self._idx_cache.get(key)
        if cached is not None:
            return cached
        rg = self.ranges
        ent_of = np.asarray(self.maps.instance_entity)
        dirty_inst = np.isin(ent_of, list(key))
        # meshes whose world bake moves: FIRST instance dirty
        dirty_mesh = {int(rg["inst_mesh"][i])
                      for i in np.flatnonzero(dirty_inst)
                      if rg["first_inst"][int(rg["inst_mesh"][i])] == i}
        # closure: triangles referencing a moved mesh's vertex rows also
        # re-bake (shared-mesh instances see the first instance's bake)
        tri_dirty = dirty_inst | np.isin(rg["inst_mesh"],
                                         list(dirty_mesh) or [-1])
        vsegs = [np.arange(rg["vstart"][m], rg["vstart"][m] + rg["vcount"][m],
                           dtype=np.int32) for m in sorted(dirty_mesh)]
        vert_idx = np.concatenate(vsegs) if vsegs \
            else np.zeros((0,), np.int32)
        tsegs = [np.arange(rg["tri_start"][i], rg["tri_end"][i],
                           dtype=np.int32)
                 for i in np.flatnonzero(tri_dirty)]
        tri_idx = np.concatenate(tsegs) if tsegs \
            else np.zeros((0,), np.int32)

        def pad(a):
            # pad (with row 0 — idempotent recompute) to a quantum
            # multiple so different dirty sets share jit traces
            n = max(_PAD_QUANTUM,
                    -(-len(a) // _PAD_QUANTUM) * _PAD_QUANTUM)
            return np.pad(a, (0, n - len(a))).astype(np.int32)

        out = (jnp.asarray(pad(vert_idx)), jnp.asarray(pad(tri_idx)),
               bool(rg["emissive"][dirty_inst].any()),
               int(tri_idx.size))
        self._idx_cache[key] = out
        return out

    def commit_and_render(self, cam_state, **kw):
        """Fused commit + refit + render: ONE device dispatch per
        dynamic frame instead of three (update, refit, frame). Falls
        back to a plain render when nothing is dirty. The per-frame
        Scene::OnUpdate-inside-the-submission analog
        (Scene.cpp:148-189)."""
        r = self.renderer
        if not self._dirty_entities:
            return r.render(cam_state, **kw)
        key = frozenset(self._dirty_entities)
        vert_idx, tri_idx, lights_dirty, n_tri = self._dirty_indices(key)
        use_subset = bool(n_tri
                          and tri_idx.shape[0] <= self.ranges["n_tris"] // 2)
        out = r.render_dynamic(cam_state, self.maps,
                               jnp.asarray(self._transforms), vert_idx,
                               tri_idx, use_subset=use_subset,
                               update_lights=lights_dirty, **kw)
        self._dirty_entities.clear()
        return out

    def commit(self):
        if not self._dirty_entities:
            return
        r = self.renderer
        key = frozenset(self._dirty_entities)
        vert_idx, tri_idx, lights_dirty, n_tri = self._dirty_indices(key)
        if n_tri and tri_idx.shape[0] <= self.ranges["n_tris"] // 2:
            new_data = update_transforms_subset(
                r.scene, self.maps, jnp.asarray(self._transforms),
                vert_idx, tri_idx, update_lights=lights_dirty)
        else:
            new_data = update_transforms(r.scene, self.maps,
                                         jnp.asarray(self._transforms))
        r.scene = new_data
        if r.tracer is not None:
            r.tracer = r.tracer.refit(new_data)
        self._dirty_entities.clear()
