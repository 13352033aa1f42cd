"""Dynamic scene updates: device transform re-sync + BVH refit + motion.

Covers per-frame entity-transform updates,
acceleration refit, and real (non-camera) object motion through the
G-buffer motion math (Scene.cpp:148-189 / SyncInstancesToGPU analog).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import DisplayMode, RenderFlags, \
    RenderPathType
from hybridrenderer.ops import bvh as bvh_mod
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import dynamic, scene as scenes


def _translate(x, y, z):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [x, y, z]
    return t


def test_refit_repacks_kernel_nodes_like_a_fresh_build():
    """SceneTracer.refit with unchanged geometry repacks the CUDA
    kernel's node and leaf records bit-identically to the build."""
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.ops import trace_cuda
    from hybridrenderer.ops.trace import SceneTracer

    data = scenes.cornell_scene().build()
    tracer = SceneTracer.build(data, RenderSettings(trace_backend="jnp"))
    s = data.triangles
    nodes, tris = trace_cuda.pack_nodes(tracer.bvh, s.v0, s.v1, s.v2)
    kernel_tracer = dataclasses.replace(tracer, backend="kernel",
                                        nodes=nodes, leaf_tris=tris)
    refit = kernel_tracer.refit(data)
    np.testing.assert_array_equal(np.asarray(refit.nodes),
                                  np.asarray(nodes))
    np.testing.assert_array_equal(np.asarray(refit.leaf_tris),
                                  np.asarray(tris))


def test_refit_bvh_valid_after_motion():
    data = scenes.cube_scene().build()
    s = data.triangles
    b = bvh_mod.build_bvh(s.v0, s.v1, s.v2)
    moved0 = s.v0 + jnp.array([3.0, 0.0, 1.0])
    moved1 = s.v1 + jnp.array([3.0, 0.0, 1.0])
    moved2 = s.v2 + jnp.array([3.0, 0.0, 1.0])
    b2 = bvh_mod.refit_bvh(b, moved0, moved1, moved2)
    assert bvh_mod.validate_bvh(
        dataclasses.replace(b2), moved0, moved1, moved2)


def test_refit_bvh_exact_height_matches_conservative():
    """tree_height-bounded refit (what SceneTracer.refit runs) is
    bit-identical to the conservative ~40-sweep bound."""
    data = scenes.stress_scene(num_objects=25).build()
    s = data.triangles
    b = bvh_mod.build_bvh_host(s.v0, s.v1, s.v2, builder="sah")
    h = bvh_mod.tree_height(b.left, b.right, int(np.asarray(b.num_tris)))
    assert 2 <= h < 64
    moved0 = s.v0 + jnp.array([1.0, 2.0, 0.5])
    moved1 = s.v1 + jnp.array([1.0, 2.0, 0.5])
    moved2 = s.v2 + jnp.array([1.0, 2.0, 0.5])
    ref = bvh_mod.refit_bvh(b, moved0, moved1, moved2)
    fast = bvh_mod.refit_bvh(b, moved0, moved1, moved2, max_depth_iters=h)
    np.testing.assert_array_equal(np.asarray(ref.node_min),
                                  np.asarray(fast.node_min))
    np.testing.assert_array_equal(np.asarray(ref.node_max),
                                  np.asarray(fast.node_max))


def test_refit_rmq_matches_scan_refit():
    """RMQ sparse-table refit (what SceneTracer.refit runs when the
    plan exists) is bit-identical to the bottom-up scan refit, on both
    builders."""
    data = scenes.stress_scene(num_objects=25).build()
    s = data.triangles
    for builder in ("sah", "lbvh"):
        b = bvh_mod.build_bvh_host(s.v0, s.v1, s.v2, builder=builder)
        rows, K = bvh_mod.refit_plan(
            b.left, b.right, int(np.asarray(b.num_tris)))
        assert rows is not None and K >= 1
        moved0 = s.v0 * 1.1 + jnp.array([1.0, 2.0, 0.5])
        moved1 = s.v1 * 1.1 + jnp.array([1.0, 2.0, 0.5])
        moved2 = s.v2 * 1.1 + jnp.array([1.0, 2.0, 0.5])
        ref = bvh_mod.refit_bvh(b, moved0, moved1, moved2)
        fast = bvh_mod.refit_bvh_rmq(b, moved0, moved1, moved2,
                                     jnp.asarray(rows), K)
        np.testing.assert_array_equal(np.asarray(ref.node_min),
                                      np.asarray(fast.node_min))
        np.testing.assert_array_equal(np.asarray(ref.node_max),
                                      np.asarray(fast.node_max))


def test_update_transforms_consistency():
    """Moving an entity through the dynamic path produces the same
    SceneData arrays as rebuilding the host scene at the new pose."""
    host = scenes.cube_scene()
    data = host.build()
    maps = dynamic.build_maps(host)
    rows = host._built["rows"]
    tf = np.stack([r[1] for r in rows]).astype(np.float32)
    tf[1] = _translate(2.0, 0.75, -1.0)   # move the cube instance

    updated = dynamic.update_transforms(data, maps, jnp.asarray(tf))

    host2 = scenes.cube_scene()
    host2.entities[1].transform = _translate(2.0, 0.75, -1.0)
    fresh = host2.build()

    np.testing.assert_allclose(np.asarray(updated.triangles.v0),
                               np.asarray(fresh.triangles.v0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(updated.instances.aabb_min),
                               np.asarray(fresh.instances.aabb_min),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(updated.instances.aabb_max),
                               np.asarray(fresh.instances.aabb_max),
                               atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(updated.instances.inverse_transform[1]),
        np.asarray(fresh.instances.inverse_transform[1]), atol=1e-5)
    # prev_transform carries the OLD pose (object motion visible)
    np.testing.assert_allclose(np.asarray(updated.instances.prev_transform),
                               np.asarray(data.instances.transform),
                               atol=0)


def test_light_cdf_refit():
    """Scaling an emissive entity's transform rescales its CDF areas."""
    host = scenes.cornell_scene()
    data = host.build()
    maps = dynamic.build_maps(host)
    assert maps.cdf_tri.shape[0] == data.lights.cdf.shape[0]
    rows = host._built["rows"]
    tf = np.stack([r[1] for r in rows]).astype(np.float32)
    updated = dynamic.update_transforms(data, maps, jnp.asarray(tf))
    np.testing.assert_allclose(np.asarray(updated.lights.cdf),
                               np.asarray(data.lights.cdf), rtol=1e-5)


def test_update_transforms_subset_matches_full():
    """The dirty-only update path (update_transforms_subset) produces
    EXACTLY the same SceneData as the full re-bake for the same new
    transforms — scene arrays, attr/raster rows and light CDF."""
    host = scenes.cornell_scene()
    data = host.build()
    maps = dynamic.build_maps(host)
    rg = dynamic.build_host_ranges(host)
    rows = host._built["rows"]
    tf = np.stack([r[1] for r in rows]).astype(np.float32)
    ent_of = np.asarray(maps.instance_entity)
    # move entity 1's instances
    dirty_inst = ent_of == 1
    tf[dirty_inst] = _translate(0.3, 0.1, -0.2) @ tf[dirty_inst][0]

    full = dynamic.update_transforms(data, maps, jnp.asarray(tf))

    # dirty index sets via the DynamicScene helper machinery
    class _R:  # minimal renderer stand-in
        scene = data
        tracer = None
    dyn = dynamic.DynamicScene(host, _R())
    dyn.set_entity_transform(1, tf[np.flatnonzero(dirty_inst)[0]])
    vert_idx, tri_idx, lights_dirty, n_tri = dyn._dirty_indices(
        frozenset({1}))
    assert n_tri > 0
    sub = dynamic.update_transforms_subset(
        data, maps, jnp.asarray(dyn._transforms), vert_idx, tri_idx,
        update_lights=lights_dirty)

    for name in ("v0", "v1", "v2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sub.triangles, name)),
            np.asarray(getattr(full.triangles, name)), err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(sub.vertices.world_position),
        np.asarray(full.vertices.world_position))
    np.testing.assert_array_equal(np.asarray(sub.attr_rows),
                                  np.asarray(full.attr_rows))
    np.testing.assert_array_equal(np.asarray(sub.lights.cdf),
                                  np.asarray(full.lights.cdf))
    np.testing.assert_array_equal(np.asarray(sub.instances.transform),
                                  np.asarray(full.instances.transform))
    np.testing.assert_array_equal(np.asarray(sub.instances.prev_transform),
                                  np.asarray(full.instances.prev_transform))


def test_animated_entity_render_and_motion_vectors():
    """Turntable test: a moving cube renders correctly after dynamic
    update + refit, and the G-buffer motion plane shows nonzero object
    motion with a static camera."""
    host = scenes.cube_scene()
    data = host.build()
    settings = RenderSettings(
        width=96, height=96, path=RenderPathType.HYBRID,
        flags=RenderFlags.default_hybrid())
    r = Renderer.for_scene(settings, data)
    dyn = dynamic.DynamicScene(host, r)
    cam = OrbitCamera(width=96, height=96, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    cs = cam.step()

    img0 = r.render_np(cs)
    dyn.set_entity_transform(1, _translate(1.2, 0.75, 0.0))
    dyn.commit()
    img1 = r.render_np(cs)
    assert np.isfinite(img1).all()
    # the cube moved: the image changes substantially
    assert np.abs(img1 - img0).mean() > 1e-3

    # motion display mode: static camera => motion comes from the object
    r2 = Renderer(settings.replace(display_mode=DisplayMode.MOTION),
                  r.scene, tracer=r.tracer)
    motion_img = r2.render_np(cs)
    assert np.isfinite(motion_img).all()
    assert float(np.abs(motion_img).max()) > 1e-4

    # after the moved frame, committing with no further motion zeroes
    # prev/current delta again
    dyn.set_entity_transform(1, _translate(1.2, 0.75, 0.0))
    dyn.commit()
    img2 = r.render_np(cs)
    assert np.isfinite(img2).all()


def test_dynamic_render_matches_fresh_build():
    """Image through dynamic update + refit == image from a from-scratch
    scene at the same pose (topology differs only in traversal order)."""
    host = scenes.cube_scene()
    data = host.build()
    settings = RenderSettings(width=64, height=64,
                              path=RenderPathType.HYBRID,
                              flags=RenderFlags.default_hybrid())
    r = Renderer.for_scene(settings, data)
    dyn = dynamic.DynamicScene(host, r)
    dyn.set_entity_transform(1, _translate(0.8, 0.75, 0.4))
    dyn.commit()
    r.reset_history()
    img_dyn = r.render_np(OrbitCamera(width=64, height=64, distance=7.0,
                                      pitch=0.45, yaw=0.6,
                                      focal_point=(0, 0.7, 0)).step())

    host2 = scenes.cube_scene()
    host2.entities[1].transform = _translate(0.8, 0.75, 0.4)
    # fresh build: prev == current (no motion) — mirror that state for
    # comparability by committing twice in the dynamic path above? No:
    # motion affects only history-driven passes; frame 0 has none.
    fresh = host2.build()
    r2 = Renderer.for_scene(settings, fresh)
    img_fresh = r2.render_np(OrbitCamera(width=64, height=64, distance=7.0,
                                         pitch=0.45, yaw=0.6,
                                         focal_point=(0, 0.7, 0)).step())
    np.testing.assert_allclose(img_dyn, img_fresh, atol=2e-2)


def test_commit_and_render_matches_split_dispatch():
    """The fused one-dispatch dynamic frame (commit_and_render) is
    pixel-identical to commit(); render() — same update, refit, and
    frame math, one device program."""
    host = scenes.cube_scene()
    settings = RenderSettings(
        width=96, height=96, path=RenderPathType.HYBRID,
        flags=RenderFlags.default_hybrid())
    cam = OrbitCamera(width=96, height=96, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    cs = cam.step()

    def run(fused: bool):
        r = Renderer.for_scene(settings, host.build())
        dyn = dynamic.DynamicScene(host, r)
        imgs = []
        for i in range(3):
            dyn.set_entity_transform(1, _translate(0.4 * i, 0.75, 0.0))
            if fused:
                imgs.append(np.asarray(dyn.commit_and_render(cs)))
            else:
                dyn.commit()
                imgs.append(r.render_np(cs))
        return imgs

    for a, b in zip(run(False), run(True)):
        np.testing.assert_array_equal(a, b)
