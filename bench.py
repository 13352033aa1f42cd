"""Benchmark entry: prints ONE JSON line. Runs on a GPU only.

Headline metric: hybrid-path FPS (RT shadows + AO + SVGF) at 1080p on the
procedural stress scene (65k triangles). The ``extra`` field carries a
breakdown from a flag-bisect ladder run in the same process (pass cost =
delta between rungs), the forward-path and full-graph (REFLECTION|GI)
configs, the dynamic-scene and larger-scene rungs, the golden check,
and the device (kind, count, name and power limit).

Env overrides for diagnostics:
  BENCH_WIDTH/BENCH_HEIGHT, BENCH_SCENE (stress|cube|cornell),
  BENCH_PATH (hybrid|forward), BENCH_FRAMES, BENCH_OBJECTS,
  BENCH_BREAKDOWN=0 to skip the ladder (headline only).
"""
from __future__ import annotations

import json
import os
import sys
import time


def _time_config(settings, data, cam_kw, frames, burst=None,
                 stats_sink=None):
    """ms/frame for one static config; chained frames, one readback fence,
    first post-compile execution discarded.

    ``burst`` > 1 submits that many frames per dispatch via
    Renderer.render_burst (frames-in-flight analog)."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.runtime.renderer import Renderer

    if burst is None:
        burst = int(os.environ.get("BENCH_BURST", "8"))
    r = Renderer.for_scene(settings, data)
    cam = OrbitCamera(width=settings.width, height=settings.height, **cam_kw)

    def steps(n):
        out = []
        for _ in range(n):
            out.append(cam.step(taa_enabled=True))
            cam.orbit(0.01, 0.0)
        return out

    if burst <= 1:
        out = r.render(steps(1)[0])
        out = r.render(steps(1)[0])
        _ = np.asarray(out[0, 0])
        t0 = time.perf_counter()
        for c in steps(frames):
            out = r.render(c)
        _ = np.asarray(out[0, 0])
        if stats_sink is not None:
            stats_sink.update(r.frame_stats())
        return 1000.0 * (time.perf_counter() - t0) / frames

    frames = max(frames, burst)
    out = r.render_burst(steps(burst))           # cold: compile + warm
    out = r.render_burst(steps(burst))           # warm variant compile
    _ = np.asarray(out[-1, 0, 0])
    n_bursts = max(1, frames // burst)
    t0 = time.perf_counter()
    for _ in range(n_bursts):
        out = r.render_burst(steps(burst))
    _ = np.asarray(out[-1, 0, 0])
    if stats_sink is not None:
        stats_sink.update(r.frame_stats())
    return 1000.0 * (time.perf_counter() - t0) / (n_bursts * burst)


def rot_y(a):
    import numpy as np

    c, s = float(np.cos(a)), float(np.sin(a))
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)


def dynamic_ms(host, data, settings, cam_kw, frames: int = 4):
    """ms/frame of the dynamic rung (Scene::OnUpdate parity): entity 0
    rotates every frame → on-device transform re-sync + BVH refit +
    render, commit and render dispatched separately."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene.dynamic import DynamicScene

    r = Renderer.for_scene(settings, data)
    dyn = DynamicScene(host, r)
    cam = OrbitCamera(width=settings.width, height=settings.height, **cam_kw)

    def frame(a):
        dyn.set_entity_transform(0, rot_y(a))
        dyn.commit()
        return r.render(cam.step(taa_enabled=True))

    out = frame(0.05)
    out = frame(0.10)
    _ = np.asarray(out[0, 0])
    t0 = time.perf_counter()
    for i in range(frames):
        out = frame(0.15 + 0.05 * i)
    _ = np.asarray(out[0, 0])
    return 1000.0 * (time.perf_counter() - t0) / frames


def golden_offedge():
    """Per-pixel error of the cube forward render against its stored
    golden, split by a 1-px-dilated triangle-boundary mask: winner flips
    from a different float order can only live on boundaries, so error
    above 16 OFF the mask is a raster bug (tests/test_golden.py)."""
    import jax.numpy as jnp
    import numpy as np

    from hybridrenderer.core import maths
    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.ops import raster as raster_ops
    from hybridrenderer.ops.image import tri_boundary_mask
    from hybridrenderer.runtime.output import read_png, to_u8
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene import scene as scenes

    gold_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "goldens", "cube_forward_64.png")
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL)
    r = Renderer(s, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    cs = cam.step()
    img = to_u8(r.render_np(cs))
    diff = np.abs(img.astype(int) - read_png(gold_path).astype(int))
    planes = maths.frustum_from_viewproj(
        maths.mm(jnp.asarray(cs.proj), jnp.asarray(cs.view)))
    culled = maths.aabb_outside_frustum(
        data.instances.aabb_min, data.instances.aabb_max, planes)
    vis = raster_ops.rasterize_scene(
        data.vertices.world_position, data.triangles.i0, data.triangles.i1,
        data.triangles.i2, cs, 64, 64, jitter_enabled=False,
        tri_mask=~culled[data.triangles.instance],
        single_sided=data.triangles.single_sided)
    edge = tri_boundary_mask(vis.tri_id, dilate=1)
    err = diff.max(axis=-1)
    off = err[~edge]
    return {
        "golden_err_max": int(diff.max()),
        "golden_err_p99": float(np.percentile(diff, 99)),
        "golden_err_onedge_max": int(err[edge].max()) if edge.any() else 0,
        "golden_err_offedge_max": int(off.max()) if off.size else 0,
        "golden_offedge_ok": bool(off.size == 0 or off.max() <= 16),
    }


def main():
    width = int(os.environ.get("BENCH_WIDTH", "1920"))
    height = int(os.environ.get("BENCH_HEIGHT", "1080"))
    scene_name = os.environ.get("BENCH_SCENE", "stress")
    path_name = os.environ.get("BENCH_PATH", "hybrid")
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    n_objects = int(os.environ.get("BENCH_OBJECTS", "250"))
    breakdown = os.environ.get("BENCH_BREAKDOWN", "1") != "0"

    from hybridrenderer.runtime import device

    xla_flags = device.set_launcher_flags()
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.scene import scene as scenes

    device.require_gpu()
    if scene_name == "stress":
        host = scenes.stress_scene(num_objects=n_objects)
    elif scene_name == "stress_textured":
        host = scenes.stress_scene(num_objects=n_objects, textured=True)
    elif scene_name == "cornell":
        host = scenes.cornell_scene()
    else:
        host = scenes.cube_scene()
    data = host.build()

    SV = (RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
          | RenderFlags.SVGF_SPATIAL)
    BASE = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
    hybrid_flags = BASE | RenderFlags.SHADOW | RenderFlags.AO | SV
    forward_flags = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA

    if path_name == "hybrid":
        ptype, flags = RenderPathType.HYBRID, hybrid_flags
    else:
        ptype, flags = RenderPathType.FORWARD, forward_flags

    cam_kw = dict(distance=30.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))

    def settings_for(pt, fl):
        return RenderSettings(width=width, height=height, path=pt, flags=fl)

    head_stats = {}
    headline_ms = _time_config(settings_for(ptype, flags), data, cam_kw,
                               frames, stats_sink=head_stats)
    fps = 1000.0 / headline_ms

    extra = {
        "ms_per_frame": round(headline_ms, 2),
        "triangles": int(data.num_triangles),
        "device": {**device.describe(),
                   "name_power_limit": device.name_and_power_limit()},
        "xla_flags": xla_flags,
        "frames": frames,
    }

    if breakdown and path_name == "hybrid":
        # fused flag-bisect: pass cost = delta between ladder rungs
        ladder_frames = max(4, frames // 2)
        # ACTIVE rays: rays are only traced for covered pixels (the
        # G-buffer hit mask gates every RT pass), so the Mrays
        # denominator is covered_pixels, not W*H.
        covered = head_stats.get("covered_pixels") or (width * height)
        rays = covered / 1e6  # active Mrays per 1-spp pass

        def t(fl):
            return _time_config(settings_for(RenderPathType.HYBRID, fl),
                                data, cam_kw, ladder_frames)

        raster_ms = t(BASE)
        shadow_ms = t(BASE | RenderFlags.SHADOW) - raster_ms
        ao_total = t(BASE | RenderFlags.SHADOW | RenderFlags.AO)
        ao_ms = ao_total - raster_ms - shadow_ms
        svgf_ms = headline_ms - ao_total
        full_flags = (hybrid_flags | RenderFlags.REFLECTION | RenderFlags.GI)
        full_ms = t(full_flags)
        fwd_ms = _time_config(
            settings_for(RenderPathType.FORWARD, forward_flags), data,
            cam_kw, ladder_frames)
        extra["breakdown"] = {
            "raster_gbuffer_comp_ms": round(raster_ms, 1),
            "shadow_rays_ms": round(shadow_ms, 1),
            "ao_rays_ms": round(ao_ms, 1),
            "svgf_ms": round(svgf_ms, 1),
            "covered_pixels": covered,
            "coverage": round(covered / (width * height), 4),
            "mrays_shadow_active": round(1000.0 * rays / shadow_ms, 1)
            if shadow_ms > 0 else None,
            "mrays_ao_active": round(1000.0 * rays / ao_ms, 1)
            if ao_ms > 0 else None,
            "full_graph_refl_gi_ms": round(full_ms, 1),
            "forward_taa_ms": round(fwd_ms, 1),
        }
        extra["breakdown"]["dynamic_ms"] = round(dynamic_ms(
            host, data, settings_for(RenderPathType.HYBRID, hybrid_flags),
            cam_kw), 1)

        # larger procedural rungs: 4x the headline's objects (~284k
        # tris), textured at that scale (hybrid and forward), and the
        # textured headline at a 1024² texel density
        sponza_objects = int(os.environ.get("BENCH_SPONZA_OBJECTS",
                                            "1000"))
        if sponza_objects > 0:
            big = scenes.stress_scene(num_objects=sponza_objects).build()
            extra["breakdown"]["sponza_scale_ms"] = round(_time_config(
                settings_for(RenderPathType.HYBRID, hybrid_flags),
                big, cam_kw, ladder_frames), 1)
            extra["breakdown"]["sponza_scale_tris"] = int(big.num_triangles)
            bigtex = scenes.stress_scene(
                num_objects=sponza_objects, textured=True).build()
            extra["breakdown"]["sponza_textured_ms"] = round(_time_config(
                settings_for(RenderPathType.HYBRID, hybrid_flags),
                bigtex, cam_kw, ladder_frames), 1)
            extra["breakdown"]["forward_textured_ms"] = round(_time_config(
                settings_for(RenderPathType.FORWARD, forward_flags),
                bigtex, cam_kw, ladder_frames), 1)
            hitex = scenes.stress_scene(
                num_objects=n_objects, textured=True, tex_size=1024).build()
            extra["breakdown"]["headline_tex1024_ms"] = round(_time_config(
                settings_for(RenderPathType.HYBRID, hybrid_flags),
                hitex, cam_kw, ladder_frames), 1)

    extra.update(golden_offedge())

    result = {
        "metric": f"fps_{width}x{height}_{scene_name}_{path_name}",
        "value": round(fps, 3),
        "unit": "frames/sec",
        "extra": extra,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
