#!/usr/bin/env python3
"""Smoke run of the renderer on one NVIDIA GPU: the quickest proof that
the system starts on the card and that its kernels agree with their
plain references at full size.

    python chip_smoke.py                 # phases 1-4, one GPU
    python chip_smoke.py --four          # sharded 1080p frame, four GPUs
    python chip_smoke.py --ab            # time each kernel against its
                                         # plain XLA version in the frame

Phases (any failure exits non-zero; nothing is caught):
  1. device: the first JAX device must be a GPU (no CPU fallback);
  2. kernels vs references on the 65,258-triangle headline at 1920x1080:
     the Triton tile raster vs ops/raster.rasterize, the CUDA traversal
     vs intersect_bvh on the frame's own shadow / AO / reflection / GI /
     NEE rays and vs intersect_brute on a 64k-ray sample;
  3. the golden images of tests/test_golden*.py, rendered on the card,
     under their off-edge rule (error above 16 only on triangle edges);
  4. the main path at 1080p through Renderer: hybrid headline, full graph
     (reflection + GI), forward + TAA, dynamic commit + refit + render —
     chained frames, finite non-constant output, compile seconds, warm
     ms/frame and peak device memory.
The last line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

W, H = 1920, 1080
CAM_KW = dict(distance=30.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))
N_OBJECTS = 250           # stress_scene(250): 65,258 triangles
WARM_FRAMES = 8

# Tolerances, each with its reason.
TOL = {
    "raster_edge_dilate": (1, "tri_id may differ only within 1 px of a "
                              "triangle boundary: the kernel and the scan "
                              "contract edge-function products into FMAs "
                              "differently, which flips exact-edge pixels"),
    "raster_depth_rtol": (1e-4, "reversed-Z depth where winners agree: "
                                "FMA contraction / sum order"),
    "raster_bary_atol": (2e-3, "an edge function's constant term is O(x*y) "
                               "px^2 at 1080p, so one f32 ulp of it is a "
                               "measurable share of a small triangle's "
                               "area (cancellation)"),
    "trace_tuv_rtol": (1e-5, "t, u, v where hits agree: same arithmetic "
                             "term by term, XLA and nvcc may still order "
                             "the three-term dot products differently"),
    "trace_tie_rtol": (1e-6, "closest-hit triangles may differ only where "
                             "both hits have the same t (ties)"),
    "golden_offedge": (16, "u8 error off 1-px-dilated triangle edges, as "
                           "in tests/test_golden.py"),
    "golden_sampled_share": (0.05, "goldens shaded through SVGF or 1-spp "
                                   "rays: share of off-edge pixels above "
                                   "golden_offedge. SVGF's depth edge-stop "
                                   "divides by screen-space depth "
                                   "gradients (floored at 1e-8), so ulp-"
                                   "level depth differences between the "
                                   "card and the CPU that rendered the "
                                   "goldens reweight its taps on camera-"
                                   "facing planes, and a 1-spp ray can "
                                   "flip under an ulp change of its "
                                   "origin"),
    "golden_sampled_mean": (3.0, "goldens shaded through SVGF or 1-spp "
                                 "rays: mean u8 error (same reason)"),
    "sharded_atol": (1e-3, "sharded vs single-device output: GSPMD may "
                           "fuse the SVGF/TAA stencils differently per "
                           "shard (f32 sum order)"),
}


def say(*a):
    print(*a, flush=True)


def tol(name):
    return TOL[name][0]


def print_tolerances():
    for k, (v, why) in TOL.items():
        say(f"  tolerance {k} = {v}: {why}")


def headline_scene():
    from hybridrenderer.scene import scene as scenes

    host = scenes.stress_scene(num_objects=N_OBJECTS)
    return host, host.build()


def flags_for(name):
    from hybridrenderer.core.types import RenderFlags

    sv = (RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
          | RenderFlags.SVGF_SPATIAL)
    base = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
    hybrid = base | RenderFlags.SHADOW | RenderFlags.AO | sv
    return {"hybrid": hybrid,
            "full_graph": hybrid | RenderFlags.REFLECTION | RenderFlags.GI,
            "forward_taa": RenderFlags.LIGHT | RenderFlags.IBL
            | RenderFlags.TAA}[name]


def settings_for(name, **kw):
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderPathType

    path = RenderPathType.FORWARD if name == "forward_taa" \
        else RenderPathType.HYBRID
    return RenderSettings(width=W, height=H, path=path,
                          flags=flags_for(name), **kw)


# --- phase 2: kernels against their references ---------------------------

def frame_triangles(data, cam_state, settings):
    """The G-buffer pass's ClippedTriangles for this camera."""
    import jax.numpy as jnp

    from hybridrenderer.graph import passes

    _, mask = passes._instance_cull(data, cam_state)
    jit2 = jnp.asarray(cam_state.jitter)
    vp = jnp.matmul(jnp.asarray(cam_state.proj), jnp.asarray(cam_state.view),
                    precision="highest")
    return passes._clip_scene(data, settings, vp, jit2, mask)


def check_raster(data, cam_state):
    import jax
    import numpy as np

    from hybridrenderer.ops import raster, raster_tile
    from hybridrenderer.ops.image import tri_boundary_mask

    tris = frame_triangles(data, cam_state, settings_for("hybrid"))
    kern = jax.jit(lambda t: raster_tile.rasterize(t, W, H,
                                                   with_stats=True))
    vis, stats = kern(tris)
    ref = raster.rasterize(tris, W, H)
    a, b = np.asarray(ref.tri_id), np.asarray(vis.tri_id)
    off = ~tri_boundary_mask(a, dilate=tol("raster_edge_dilate"))
    bad_off = int((a != b)[off].sum())
    same = a == b
    dz = np.abs(np.asarray(vis.depth) - np.asarray(ref.depth))[same]
    zr = np.abs(np.asarray(ref.depth))[same]
    depth_bad = int((dz > tol("raster_depth_rtol") * np.maximum(zr, 1e-3))
                    .sum())
    bary = max(float(np.abs(np.asarray(getattr(vis, f))
                            - np.asarray(getattr(ref, f)))[same].max())
               for f in ("bary1", "bary2"))
    say(f"  raster 1080p: covered {int((a >= 0).sum())} px, tri_id "
        f"differs on {int((a != b).sum())} px ({bad_off} off-edge), "
        f"depth out of tol {depth_bad}, max |dbary| {bary:.3g}, entries "
        f"{stats['entries']}, dropped {int(stats['n_dropped'])}")
    assert int(stats["n_dropped"]) == 0, "raster bins dropped candidates"
    assert bad_off == 0, "raster tri_id differs off triangle edges"
    assert depth_bad == 0, "raster depth beyond tolerance"
    assert bary <= tol("raster_bary_atol"), "raster barycentrics beyond tol"


def capture_frame_rays(data, cam_state, name):
    """Run one frame of ``name`` with the CUDA tracer, recording every
    traversal call's rays (they are the frame's own shadow, AO, radiance
    and NEE rays) as outputs of the jitted frame."""
    import jax
    import jax.numpy as jnp

    from hybridrenderer.graph.params import FrameState
    from hybridrenderer.ops.trace import SceneTracer
    from hybridrenderer.runtime.renderer import Renderer

    r = Renderer.for_scene(settings_for(name), data)
    calls = []
    orig = SceneTracer._intersect

    def recording(self, scene, o, d, tmin, tmax, any_hit, active=None):
        R = o.shape[0]
        calls.append((tmin, any_hit))
        rec.append((o, d, jnp.broadcast_to(jnp.asarray(tmax, jnp.float32),
                                           (R,)),
                    jnp.ones((R,), bool) if active is None else active))
        return orig(self, scene, o, d, tmin, tmax, any_hit, active)

    rec = []
    body = r._frame_body(False)

    def frame(*args):
        rec.clear()
        calls.clear()
        out, _, _ = body(*args)
        return out, list(rec)

    packed = r._pack_row(cam_state, 1.0, (4.0, 128.0, 0.02, 0.0), 0)
    SceneTracer._intersect = recording
    try:
        out, rays = jax.jit(frame)(r.scene, packed, FrameState.empty(),
                                   r.tracer)
    finally:
        SceneTracer._intersect = orig
    return r.tracer, out, [(t, a, *x) for (t, a), x in zip(calls, rays)]


def check_traversal(data, cam_state):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hybridrenderer.ops import trace, trace_cuda

    tracer, _, ray_sets = capture_frame_rays(data, cam_state, "full_graph")
    ref_tracer = trace.SceneTracer(
        bvh=tracer.bvh, backend="jnp", bvh_height=tracer.bvh_height)
    soup = data.triangles
    kern = jax.jit(trace_cuda.intersect, static_argnums=(2, 5, 7))
    ref_fn = jax.jit(lambda o, d, tmin, tmax, act, any_hit: ref_tracer
                     ._intersect(data, o, d, tmin, tmax, any_hit, act),
                     static_argnums=(2, 5))
    sample = None
    for i, (tmin, any_hit, o, d, tmax, act) in enumerate(ray_sets):
        got = kern(tracer.nodes, tracer.leaf_tris, tracer.root, o, d,
                   tmin, tmax, any_hit, act)
        ref = ref_fn(o, d, tmin, tmax, act, any_hit)
        gt, gtri, gu, gv = map(np.asarray, got)
        rt, rtri, ru, rv = map(np.asarray, ref)
        n_act = int(np.asarray(act).sum())
        vis_bad = int(((gtri >= 0) != (rtri >= 0)).sum())
        kind = "any-hit" if any_hit else "closest"
        line = (f"  traversal set {i} ({kind}, tmin {tmin}): "
                f"{o.shape[0]} rays, {n_act} active, {int((rtri >= 0).sum())}"
                f" hits, visibility mismatches {vis_bad}")
        assert vis_bad == 0, line + " -> visibility differs"
        if not any_hit:
            hit = rtri >= 0
            diff = (gtri != rtri)[hit]

            def rel(g, r):
                return np.abs(g[hit] - r[hit]) / np.maximum(np.abs(r[hit]),
                                                            1.0)

            nontie = int((diff & (rel(gt, rt) > tol("trace_tie_rtol")))
                         .sum())
            tuv = max(float(rel(g, r)[~diff].max(initial=0.0))
                      for g, r in ((gt, rt), (gu, ru), (gv, rv)))
            line += (f", tri differs {int(diff.sum())} (non-tie {nontie}),"
                     f" max rel |dt,du,dv| {tuv:.3g}")
            assert nontie == 0, line + " -> closest hit differs off ties"
            assert tuv <= tol("trace_tuv_rtol"), line + " -> t/u/v beyond tol"
            if sample is None or o.shape[0] > sample[0].shape[0]:
                sample = (o, d, tmin, tmax)
        say(line)
    # against the O(T*R) oracle on a 64k-ray sample of radiance rays
    o, d, tmin, tmax = sample
    n = min(65536, o.shape[0] // 256 * 256)
    idx = jnp.asarray(np.random.default_rng(0).choice(
        o.shape[0], n, replace=False))
    o, d, tmax = o[idx], d[idx], tmax[idx]

    @jax.jit
    def brute(o, d, tmax):
        def chunk(args):
            oc, dc, tc = args
            return trace.intersect_brute(soup.v0, soup.v1, soup.v2, oc, dc,
                                         tmin, tc)
        outs = jax.lax.map(chunk, (o.reshape(-1, 256, 3),
                                   d.reshape(-1, 256, 3),
                                   tmax.reshape(-1, 256)))
        return [x.reshape(-1) for x in outs]

    bt, btri, _, _ = map(np.asarray, brute(o, d, tmax))
    gt, gtri, _, _ = map(np.asarray, kern(
        tracer.nodes, tracer.leaf_tris, tracer.root, o, d, tmin, tmax,
        False, None))
    vis_bad = int(((gtri >= 0) != (btri >= 0)).sum())
    hit = btri >= 0
    dt = float((np.abs(gt[hit] - bt[hit]) / np.maximum(np.abs(bt[hit]), 1.0))
               .max(initial=0.0))
    line = (f"  traversal vs intersect_brute: {n} rays, {int(hit.sum())} "
            f"hits, visibility mismatches {vis_bad}, max rel |dt| {dt:.3g}")
    say(line)
    assert vis_bad == 0 and dt <= tol("trace_tuv_rtol"), line


# --- phase 3: goldens ----------------------------------------------------

def golden_cases():
    from tests import test_golden_ladder as ladder
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.scene import scene as scenes
    from hybridrenderer.scene.loader import load_scene_file

    cases = dict(ladder.CASES)
    cases["cube_forward_64"] = dict(
        scene=scenes.cube_scene, path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT | RenderFlags.IBL, cam=ladder.CUBE_CAM,
        size=64, pinned_blocks=False)
    cases["textured_gltf_96"] = dict(
        scene=lambda: load_scene_file(os.path.join(
            ladder.GOLDEN_DIR, "textured_tri.glb")),
        path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT | RenderFlags.IBL,
        cam=dict(distance=4.0, pitch=0.3, yaw=0.2), size=96,
        pinned_blocks=False)
    return ladder.GOLDEN_DIR, cases


def render_golden(name, case, gdir):
    """Render one golden case on the card → (u8 error image, boundary
    mask of the reference raster for its last camera)."""
    import jax.numpy as jnp
    import numpy as np

    from hybridrenderer.core import maths
    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import DisplayMode, RenderFlags
    from hybridrenderer.ops import raster
    from hybridrenderer.ops.image import tri_boundary_mask
    from hybridrenderer.runtime.output import read_png, to_u8
    from hybridrenderer.runtime.renderer import Renderer

    data = case["scene"]().build()
    size = case.get("size", 128)
    kw = dict(ao_block=8, gi_block=8) \
        if case.get("pinned_blocks", True) else {}
    s = RenderSettings(width=size, height=size, path=case["path"],
                       flags=case["flags"],
                       display_mode=case.get("display", DisplayMode.FINAL),
                       **kw)
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=size, height=size, **case["cam"])
    taa = bool(case["flags"] & RenderFlags.TAA)
    for _ in range(case.get("frames", 1)):
        cs = cam.step(taa_enabled=taa)
        img = r.render_np(cs)
    err = np.abs(to_u8(img).astype(int) - read_png(
        os.path.join(gdir, name + ".png")).astype(int)).max(-1)
    jitter = taa or bool(case["flags"] & RenderFlags.SVGF)
    planes = maths.frustum_from_viewproj(
        maths.mm(jnp.asarray(cs.proj), jnp.asarray(cs.view)))
    culled = maths.aabb_outside_frustum(
        data.instances.aabb_min, data.instances.aabb_max, planes)
    vis = raster.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, cs, size, size, jitter_enabled=jitter,
        tri_mask=~culled[data.triangles.instance],
        single_sided=data.triangles.single_sided)
    return err, tri_boundary_mask(vis.tri_id, dilate=1)


def check_goldens():
    """Render every golden on the card (cases compile concurrently, each
    in its own thread) and apply the off-edge rule."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from hybridrenderer.core.types import DisplayMode, RenderPathType

    gdir, cases = golden_cases()
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        futs = {name: pool.submit(render_golden, name, case, gdir)
                for name, case in cases.items()}
        results = {name: f.result() for name, f in futs.items()}
    for name, case in cases.items():
        err, edge = results[name]
        off = err[~edge]
        off_max = int(off.max()) if off.size else 0
        share = float((off > tol("golden_offedge")).sum()) / err.size
        mean = float(err.mean())
        # forward frames and G-buffer display modes see no SVGF and no
        # sampled rays: the strict off-edge rule holds for them
        strict = case["path"] == RenderPathType.FORWARD or case.get(
            "display") in (DisplayMode.NORMAL, DisplayMode.DEPTH)
        line = (f"  golden {name}: max {int(err.max())}, mean {mean:.2f}, "
                f"p99 {float(np.percentile(err, 99)):.1f}, on-edge max "
                f"{int(err[edge].max()) if edge.any() else 0}, off-edge max "
                f"{off_max}, off-edge share above {tol('golden_offedge')}: "
                f"{share:.2e} ({'strict' if strict else 'sampled'} rule)")
        say(line)
        if strict:
            assert off_max <= tol("golden_offedge"), line + " -> off-edge"
        else:
            assert share <= tol("golden_sampled_share") and \
                mean <= tol("golden_sampled_mean"), line + " -> off-edge"


# --- phase 4: the main path ----------------------------------------------

def check_image(name, out):
    import numpy as np

    img = np.asarray(out)
    assert img.shape == (H, W, 3), (name, img.shape)
    assert np.isfinite(img).all(), f"{name}: non-finite output"
    assert float(img.std()) > 1e-3, f"{name}: constant image"
    return float(img.mean())


def peak_bytes():
    """The process's high-water mark of device memory so far (JAX cannot
    reset it, so a later config reports at least an earlier one's)."""
    import jax

    return jax.devices()[0].memory_stats().get("peak_bytes_in_use")


def frame_bytes(r, cam_state):
    """memory_analysis() of the config's own warm (history) frame: what
    the executable needs, independent of what ran before it. The frame
    was compiled by the renders, so this lowers to the cached executable."""
    m = r._get_frame_fn(True).lower(
        r.scene, r._pack_row(cam_state, 1.0, (4.0, 128.0, 0.02, 0.0),
                             r.frame_count),
        r.state, r.tracer).compile().memory_analysis()
    return dict(code=m.generated_code_size_in_bytes,
                args=m.argument_size_in_bytes, out=m.output_size_in_bytes,
                temp=m.temp_size_in_bytes)


def run_config(name, data, host=None, frames=WARM_FRAMES, **kw):
    """Render chained frames through Renderer; returns the numbers."""
    import jax
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.runtime.renderer import Renderer

    settings = settings_for("hybrid" if name == "dynamic" else name, **kw)
    r = Renderer.for_scene(settings, data)
    cam = OrbitCamera(width=W, height=H, **CAM_KW)
    render = r.render
    if host is not None:
        from hybridrenderer.scene.dynamic import DynamicScene

        dyn = DynamicScene(host, r)
        angle = [0.0]

        def render(cs):
            angle[0] += 0.05
            c, s = float(np.cos(angle[0])), float(np.sin(angle[0]))
            dyn.set_entity_transform(0, np.array(
                [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                np.float32))
            dyn.commit()
            return r.render(cs)

    first = []
    for _ in range(2):      # history-free variant, then the donated one
        t0 = time.perf_counter()
        out = render(cam.step(taa_enabled=True))
        jax.block_until_ready(out)
        first.append(time.perf_counter() - t0)
        cam.orbit(0.01, 0.0)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = render(cam.step(taa_enabled=True))
        cam.orbit(0.01, 0.0)
    jax.block_until_ready(out)
    warm_ms = 1e3 * (time.perf_counter() - t0) / frames
    mean = check_image(name, out)
    res = dict(first_call_s=[round(x, 2) for x in first],
               compile_s=round(sum(first) - 2 * warm_ms / 1e3, 2),
               warm_ms=round(warm_ms, 2),
               frame_bytes=frame_bytes(r, cam.step(taa_enabled=True)),
               process_peak_bytes=peak_bytes(),
               mean=round(mean, 4), stats=r.frame_stats())
    del r, out
    gc.collect()
    return res


def raster_tiles_xla(rec, starts, counts, entries, width, height, row0=0,
                     interpret=False, chunk=16):
    """Plain-XLA control for the tile kernel: the same binned entries,
    reduced over the candidate axis ``chunk`` entries at a time for all
    tiles at once (argmax picks the first of equal depths, so ties go to
    the lowest entry as in the kernel's strict ``>``)."""
    import jax
    import jax.numpy as jnp

    from hybridrenderer.ops import raster_tile as rt

    ntx = -(-width // rt.TILE_W)
    nty = -(-height // rt.TILE_H)
    ntiles = ntx * nty
    P = rt.TILE_H * rt.TILE_W
    t = jnp.arange(ntiles, dtype=jnp.int32)
    ty, tx = t // ntx, t % ntx
    p = jnp.arange(P, dtype=jnp.int32)
    px = (tx[:, None] * rt.TILE_W + p % rt.TILE_W).astype(jnp.float32) + 0.5
    py = (jnp.asarray(row0, jnp.int32) + ty[:, None] * rt.TILE_H
          + p // rt.TILE_W).astype(jnp.float32) + 0.5
    px, py = px[:, None, :], py[:, None, :]
    k = jnp.arange(chunk, dtype=jnp.int32)
    E = entries.shape[0]

    def sweep(carry, gs, gc, rows):
        def body(state):
            i, zb, wb = state
            kk = i * chunk + k[None, :]
            ok = kk < gc[:, None]
            idx = entries[jnp.minimum(gs[:, None] + kk, E - 1)]
            r = rec[idx]                                  # (ntiles, chunk, 16)
            e = [r[..., j:j + 1] for j in range(rt._R_Z + 3)]
            e0 = e[0] * px + e[1] * py + e[2]
            e1 = e[3] * px + e[4] * py + e[5]
            e2 = e[6] * px + e[7] * py + e[8]
            ia = e[rt._R_IA]
            z = (e0 * ia) * e[rt._R_Z] + (e1 * ia) * e[rt._R_Z + 1] \
                + (e2 * ia) * e[rt._R_Z + 2]
            if rows:
                ok &= (tx[:, None] >= r[..., rt._R_TX0].astype(jnp.int32)) \
                    & (tx[:, None] <= r[..., rt._R_TX1].astype(jnp.int32))
            cov = ok[..., None] & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) \
                & (z >= 0.0) & (z <= 1.0)
            zc = jnp.where(cov, z, -1.0)
            best = jnp.argmax(zc, axis=1)                 # (ntiles, P)
            zbest = jnp.take_along_axis(zc, best[:, None], 1)[:, 0]
            take = zbest > zb
            return (i + 1, jnp.where(take, zbest, zb),
                    jnp.where(take, jnp.take_along_axis(idx, best, 1), wb))

        n = -(-jnp.max(gc) // chunk)
        _, zb, wb = jax.lax.while_loop(lambda s: s[0] < n, body,
                                       (jnp.int32(0), *carry))
        return zb, wb

    carry = (jnp.zeros((ntiles, P), jnp.float32),
             jnp.full((ntiles, P), -1, jnp.int32))
    carry = sweep(carry, starts[:ntiles], counts[:ntiles], False)
    carry = sweep(carry, starts[ntiles + ty], counts[ntiles + ty], True)

    def image(x):
        x = x.reshape(nty, ntx, rt.TILE_H, rt.TILE_W).transpose(0, 2, 1, 3)
        return x.reshape(nty * rt.TILE_H, ntx * rt.TILE_W)[:height, :width]

    return image(carry[0]), image(carry[1])


def ab(data):
    """Each kernel against the plain XLA version it replaces, in the
    1080p hybrid headline frame (same process, same card). The raster
    has two plain controls: the reference scan and an XLA reduction over
    the kernel's own binned candidates."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.ops import raster_tile

    cs = OrbitCamera(width=W, height=H, **CAM_KW).step(taa_enabled=True)
    tris = frame_triangles(data, cs, settings_for("hybrid"))
    kernel_tiles = raster_tile.raster_tiles
    a = jax_call(lambda t: raster_tile.rasterize(t, W, H), tris)
    res = {}
    for label, kw in (("kernels", {}),
                      ("xla_binned_raster", {}),
                      ("xla_raster", dict(raster_backend="jnp")),
                      ("xla_trace", dict(trace_backend="jnp"))):
        if label == "xla_binned_raster":
            raster_tile.raster_tiles = raster_tiles_xla
            b = jax_call(lambda t: raster_tile.rasterize(t, W, H), tris)
            same = bool((np.asarray(a.tri_id) == np.asarray(b.tri_id)).all())
            say(f"  binned XLA control == tile kernel (tri_id): {same}")
            assert same, "binned XLA control disagrees with the tile kernel"
        try:
            res[label] = run_config("hybrid", data, frames=4, **kw)
        finally:
            raster_tile.raster_tiles = kernel_tiles
        say(f"  A/B {label}: {res[label]}")
    return res


def jax_call(fn, *args):
    import jax

    return jax.block_until_ready(jax.jit(fn)(*args))


def phase_four():
    """Sharded 1080p hybrid on a 4-GPU mesh vs the single-device frame."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.parallel.mesh import make_mesh
    from hybridrenderer.parallel.sharded import ShardedRenderer
    from hybridrenderer.runtime.renderer import Renderer

    assert len(jax.devices()) >= 4, f"--four needs 4 GPUs, have " \
        f"{len(jax.devices())}"
    _, data = headline_scene()
    settings = settings_for("hybrid")
    mesh = make_mesh(4)
    sharded = ShardedRenderer.for_scene(settings, data, mesh)
    single = Renderer.for_scene(settings, data)
    cam = OrbitCamera(width=W, height=H, **CAM_KW)
    cams = []
    for _ in range(7):
        cams.append(cam.step(taa_enabled=True))
        cam.orbit(0.01, 0.0)
    # the first frames of both renderers (history-free and history
    # variants) compile concurrently, each in its own thread
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        fa, fb = (pool.submit(lambda r: [np.asarray(r.render(c))
                                         for c in cams[:3]], r)
                  for r in (sharded, single))
        frames_a, frames_b = fa.result(), fb.result()
    say(f"  both renderers' first 3 frames (compiles included): "
        f"{time.perf_counter() - t0:.1f} s")
    for i, (a, b) in enumerate(zip(frames_a, frames_b)):
        check_image("sharded", a)
        diff = np.abs(a - b).max(-1)
        frac = float((diff > tol("sharded_atol")).mean())
        say(f"  frame {i}: sharded vs single max |d| {float(diff.max()):.3g},"
            f" share of pixels beyond {tol('sharded_atol')}: {frac:.2e}")
        assert frac <= 1e-3, "sharded frame differs from single-device"
    for label, r in (("sharded", sharded), ("single", single)):
        t0 = time.perf_counter()
        for c in cams[3:]:
            out = r.render(c)
        jax.block_until_ready(out)
        say(f"  {label} warm ms/frame ({len(cams) - 3} frames): "
            f"{1e3 * (time.perf_counter() - t0) / (len(cams) - 3):.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="only the sharded frame on four GPUs")
    mode.add_argument("--ab", action="store_true",
                      help="only time kernels vs their plain versions")
    args = ap.parse_args(argv)

    from hybridrenderer.runtime import device

    xla_flags = device.set_launcher_flags()
    import jax

    dev = device.require_gpu()      # phase 1: no GPU, no result
    smi = device.name_and_power_limit()
    say(f"phase 1 device: {dev.device_kind} x{len(jax.devices())}; "
        f"jax {jax.__version__}; XLA_FLAGS {xla_flags!r}")
    t_start = time.perf_counter()

    if args.four:
        say("phase 5 (--four): sharded 1080p hybrid on 4 GPUs")
        phase_four()
    elif args.ab:
        say("A/B: kernels vs plain XLA in the 1080p hybrid frame")
        ab(headline_scene()[1])
    else:
        host, data = headline_scene()
        from hybridrenderer.core.camera import OrbitCamera

        cs = OrbitCamera(width=W, height=H, **CAM_KW).step(taa_enabled=True)
        say(f"phase 2 kernels vs references: {data.num_triangles} "
            f"triangles at {W}x{H}")
        print_tolerances()
        check_raster(data, cs)
        check_traversal(data, cs)
        gc.collect()
        say("phase 3 goldens on the card")
        check_goldens()
        say(f"phase 4 main path at {W}x{H} ({smi.splitlines()[0]})")
        for name in ("hybrid", "full_graph", "forward_taa"):
            say(f"  {name}: {run_config(name, data)}")
        say(f"  dynamic: {run_config('dynamic', data, host=host, frames=4)}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
