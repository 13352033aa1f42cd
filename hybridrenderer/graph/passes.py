"""Render pass library — the reference's Renderer/Passes/ inventory as
pure traced functions over the render-graph registry.

Each ``make_*_pass(settings)`` returns (fn, reads, writes, history) ready
for ``RenderGraph.add_pass``. The FrameContext ``ctx`` carries scene,
camera state, traced FrameParams, static RenderSettings and the previous
FrameState.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..core import maths
from ..core.types import DisplayMode, RenderFlags
from ..ops import backend
from ..ops import composition as comp_ops
from ..ops import gbuffer as gbuffer_ops
from ..ops import image as img_ops
from ..ops import postprocess as post_ops
from ..ops import raster as raster_ops
from ..ops import raster_tile
from ..ops import shade, sky
from ..ops import svgf as svgf_ops
from ..ops import taa as taa_ops
from .params import RS, FrameState


@dataclasses.dataclass
class FrameContext:
    scene: Any
    cam: Any
    params: Any
    settings: Any
    state: FrameState
    history_valid: bool          # static: False on frame 0 / after resize
    shadow_query: Optional[Callable] = None  # (origin, dir, tmax) -> visibility
    trace_radiance: Optional[Callable] = None
    # fused two-query variant (sun/light shadow + AO in ONE any-hit
    # dispatch, per-ray tmax) — see SceneTracer.shadow_query_pair
    shadow_query_pair: Optional[Callable] = None
    # ClippedTriangles -> VisibilityBuffer for the raster kernel; a
    # row-sharded frame runs it on each device's rows (parallel/sharded)
    rasterize: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Geometry: raster + deferred G-buffer (DepthPrepass + GBufferPass)
# ---------------------------------------------------------------------------

def _cull_mask(settings, sc):
    """Per-triangle back-face-cullable mask, or None when culling is off
    (settings.raster_cull="none" — the reference G-buffer's CULL_NONE,
    GBufferPass.cpp:74)."""
    if getattr(settings, "raster_cull", "back") != "back":
        return None
    return sc.triangles.single_sided


def _clip_scene(sc, settings, vp, jit2, mask):
    """World → clip → near-plane-clipped candidates, transforming the
    soup's per-corner tables directly (3 small matmuls, no vertex
    gathers)."""
    corners = jnp.stack(
        [raster_ops.transform_to_clip(sc.triangles.v0, vp, jit2),
         raster_ops.transform_to_clip(sc.triangles.v1, vp, jit2),
         raster_ops.transform_to_clip(sc.triangles.v2, vp, jit2)],
        axis=1)
    return raster_ops.clip_triangles(
        None, None, None, None, settings.width, settings.height,
        mask, _cull_mask(settings, sc), corners=corners)


def _rasterize(ctx, settings, jitter_on, mask):
    """Visibility buffer of the triangles in ``mask``: the binned tile
    kernel (ops/raster_tile.py) or the jnp reference scan, as
    settings.raster_backend resolves (ops/backend.py). A row-sharded
    frame supplies ``ctx.rasterize`` to run the kernel on its own rows."""
    sc, cam = ctx.scene, ctx.cam
    if backend.resolve(settings.raster_backend) == "kernel":
        vp = jnp.matmul(jnp.asarray(cam.proj), jnp.asarray(cam.view),
                        precision=maths.HIGHEST)
        jit2 = jnp.asarray(cam.jitter) if jitter_on else None
        tris = _clip_scene(sc, settings, vp, jit2, mask)
        if ctx.rasterize is not None:
            return ctx.rasterize(tris)
        return raster_tile.rasterize(tris, settings.width, settings.height)
    return raster_ops.rasterize_scene(
        sc.vertices.world_position, sc.triangles.i0, sc.triangles.i1,
        sc.triangles.i2, cam, settings.width, settings.height,
        jitter_enabled=jitter_on, tri_mask=mask,
        single_sided=_cull_mask(settings, sc))


def _instance_cull(sc, cam):
    """(per-instance culled, per-triangle visible mask) against the
    camera frustum."""
    vp = jnp.matmul(jnp.asarray(cam.proj), jnp.asarray(cam.view),
                    precision=maths.HIGHEST)
    planes = maths.frustum_from_viewproj(vp)
    culled = maths.aabb_outside_frustum(
        sc.instances.aabb_min, sc.instances.aabb_max, planes)
    return culled, ~culled[sc.triangles.instance]


def make_depth_prepass(settings):
    """DepthPrepass (DepthPrepass.cpp:16-77): depth-only raster for the
    ray-traced path — the visibility-buffer raster WITHOUT the deferred
    attribute-gather stage (the expensive half of the G-buffer). Like
    the reference's prepass it draws position-only (no alpha test)."""

    def fn(reg, ctx: FrameContext):
        _, tri_mask = _instance_cull(ctx.scene, ctx.cam)
        jitter_on = bool(settings.flags & RenderFlags.TAA)
        vis = _rasterize(ctx, settings, jitter_on, tri_mask)
        return {RS.DEPTH: vis.depth}

    return fn, (), (RS.DEPTH,), {}


def make_gbuffer_pass(settings):
    """GBufferPass (GBufferPass.cpp:13-139): full MRT G-buffer.

    Instance frustum culling replaces the reference's octree traversal
    with a dense vectorized AABB test (see scene/scene.py docstring).
    Raster backend: see ``_rasterize``.
    """

    def fn(reg, ctx: FrameContext):
        sc, cam = ctx.scene, ctx.cam
        culled, tri_mask = _instance_cull(sc, cam)
        jitter_on = bool(settings.flags & RenderFlags.TAA) or \
            bool(settings.flags & RenderFlags.SVGF)

        def raster(mask):
            return _rasterize(ctx, settings, jitter_on, mask)

        if sc.has_alpha_test:
            # gbuffer.frag:33 alpha-test discard, deferred formulation:
            # raster opaque and cut-out triangles separately, evaluate
            # the winning cut-out texel's alpha, keep it only where it
            # passes the cutoff AND is closer (reversed-Z) than the
            # opaque winner. One cut-out depth layer (a transparent
            # texel in front of a second cut-out layer falls through to
            # the opaque surface behind both).
            mat_of_tri = sc.instances.material[sc.triangles.instance]
            tri_cut = (sc.materials.alpha_mode[mat_of_tri] == 1) \
                & (sc.materials.colour_texture[mat_of_tri] >= 0)
            vis_op = raster(tri_mask & ~tri_cut)
            vis_cut = raster(tri_mask & tri_cut)
            alpha_ok = gbuffer_ops.cutout_alpha_pass(vis_cut, sc)
            keep = (vis_cut.tri_id >= 0) & alpha_ok \
                & (vis_cut.depth > vis_op.depth)
            vis = raster_ops.VisibilityBuffer(
                tri_id=jnp.where(keep, vis_cut.tri_id, vis_op.tri_id),
                bary1=jnp.where(keep, vis_cut.bary1, vis_op.bary1),
                bary2=jnp.where(keep, vis_cut.bary2, vis_op.bary2),
                depth=jnp.where(keep, vis_cut.depth, vis_op.depth),
            )
        else:
            vis = raster(tri_mask)
        # materialize the visibility buffer: its unflatten transposes
        # otherwise fuse-duplicate into every G-buffer gather chain
        vis = jax.lax.optimization_barrier(vis)
        gb = gbuffer_ops.build_gbuffer(vis, sc, cam)
        # FrameStats (Application.h:49-54 / GBufferPass.cpp:131-138):
        # instance drawn/culled counts + covered-pixel count (the
        # active-ray denominator for honest Mrays — background pixels
        # trace nothing), cheap device-side reductions
        drawn = jnp.sum((~culled).astype(jnp.int32))
        covered = jnp.sum((vis.tri_id >= 0).astype(jnp.int32))
        stats = jnp.stack([drawn, culled.shape[0] - drawn, covered])
        return {
            "_GBuffer": gb,
            "_FrameStats": stats,
            RS.ALBEDO: gb.albedo,
            RS.NORMAL: gb.normal,
            RS.MATERIAL_PARAMS: gb.material,
            RS.OBJECT_ID: gb.object_id,
            RS.MOTION: gb.motion_plane(),
            RS.EMISSIVE: gb.emissive,
            RS.DEPTH: gb.depth,
            RS.WORLD_POS: gb.world_pos,
        }

    reads = ()
    writes = ("_GBuffer", "_FrameStats", RS.ALBEDO, RS.NORMAL,
              RS.MATERIAL_PARAMS, RS.OBJECT_ID, RS.MOTION, RS.EMISSIVE,
              RS.DEPTH, RS.WORLD_POS)
    history = {RS.NORMAL: RS.NORMAL, RS.OBJECT_ID: RS.OBJECT_ID,
               RS.MOTION: RS.MOTION, RS.DEPTH: RS.DEPTH}
    return fn, reads, writes, history


# ---------------------------------------------------------------------------
# Forward shading (ForwardPass, forward.frag)
# ---------------------------------------------------------------------------

def make_forward_pass(settings):
    """ForwardPass (ForwardPass.cpp:14-87 / forward.frag): single-pass PBR
    with optional ray-query sun shadow and sky-based ambient."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        sc, cam, params = ctx.scene, ctx.cam, ctx.params
        flags = settings.flags
        bg = gb.background

        n = maths.normalize(jnp.where(bg[..., None],
                                      jnp.array([0.0, 1.0, 0.0]), gb.normal))
        v = maths.normalize(cam.position - gb.world_pos)
        l = maths.normalize(-params.sun_direction)
        intensity = params.sun_color * params.sun_intensity \
            if flags & RenderFlags.LIGHT else jnp.zeros((3,), jnp.float32)

        # inline ray-query sun shadow (forward.frag:36-40)
        if ctx.shadow_query is not None and (flags & RenderFlags.SHADOW):
            shadow = ctx.shadow_query(gb.world_pos, n,
                                      jnp.broadcast_to(l, gb.world_pos.shape),
                                      1000.0, active=~bg)
        else:
            shadow = jnp.ones_like(gb.depth)

        rough = gb.material[..., 0]
        metal = gb.material[..., 1]
        direct = shade.eval_pbr(gb.albedo, 1.5, rough, metal, n, v, l) * \
            shadow[..., None] * intensity

        # ambient / IBL (forward.frag:42-58)
        # FWD_STAGE (diagnostic): "flatamb" = skip the two env evals
        # (ambient falls back to flat), "noskybg" = skip the background
        # sky block entirely — decomposes the forward pass's IBL cost
        fwd_stage = os.environ.get("FWD_STAGE", "full")
        has_sky = bool(flags & RenderFlags.IBL) \
            and fwd_stage != "flatamb"
        if has_sky:
            r = maths.reflect(-v, n)
            env_spec = sky.sample_environment(r, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            env_diff = sky.sample_environment(n, sc.sky_texture, sc.textures,
                                              True, sc.has_sky_texture)
            f0 = maths.mix(jnp.full_like(gb.albedo, 0.04), gb.albedo,
                           metal[..., None])
            f = shade.fresnel_schlick(f0, n, v)
            kd = (1.0 - f) * (1.0 - metal[..., None])
            ambient = (kd * env_diff * gb.albedo + f * env_spec) * \
                params.ambient_strength
        else:
            ambient = params.ambient_strength * gb.albedo

        color = ambient + direct + gb.emissive

        mode = settings.display_mode
        if mode == DisplayMode.ALBEDO:
            color = gb.albedo
        elif mode == DisplayMode.NORMAL:
            color = n * 0.5 + 0.5
        elif mode == DisplayMode.MATERIAL:
            color = jnp.stack([rough, metal, jnp.ones_like(rough)], -1)
        elif mode == DisplayMode.MOTION:
            color = jnp.concatenate(
                [jnp.abs(gb.motion) * 100.0, jnp.zeros_like(gb.depth)[..., None]], -1)
        elif mode == DisplayMode.DEPTH:
            color = gb.depth[..., None] * jnp.ones(3)

        # background: sky (or black) — forward path has no composition pass
        if fwd_stage == "noskybg":
            sky_rgb = jnp.zeros_like(color)
        else:
            H, W = gb.depth.shape
            uv = img_ops.pixel_uv_grid(H, W)
            ndc = jnp.concatenate(
                [uv * 2.0 - 1.0, jnp.zeros((H, W, 1)),
                 jnp.ones((H, W, 1))], -1)
            far_h = maths.mm(ndc, cam.view_proj_inverse.T)
            far_pt = far_h[..., :3] / jnp.where(
                jnp.abs(far_h[..., 3:4]) < 1e-12, 1e-12, far_h[..., 3:4])
            bg_dir = maths.normalize(far_pt - cam.position)
            # has_sky MUST be the static scene flag: the default-True
            # path is a discarded 2M-row gather into the placeholder
            # stack
            sky_rgb = sky.sample_environment(
                bg_dir, sc.sky_texture, sc.textures,
                bool(flags & RenderFlags.IBL),
                has_sky=sc.has_sky_texture)
        color = jnp.where(bg[..., None], sky_rgb, color)
        return {RS.FINAL_COLOR: color}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}


# ---------------------------------------------------------------------------
# TAA (TAAPass, taa.comp)
# ---------------------------------------------------------------------------

def make_taa_pass(settings, use_gbuffer: bool = True):
    """``use_gbuffer=False`` reads the named Motion/Depth resources
    instead of the G-buffer struct (the ray-traced path: DepthPrepass
    depth + RT-written motion, RayTracedRenderPath.cpp:21-38)."""

    def fn(reg, ctx: FrameContext):
        if use_gbuffer:
            gb = reg["_GBuffer"]
            motion, depth = gb.motion, gb.depth
        else:
            motion = reg[RS.MOTION][..., :2]
            depth = reg[RS.DEPTH]
        history = reg.get("History_" + RS.TAA_OUTPUT)
        if history is None:
            history = reg[RS.FINAL_COLOR]
        out = taa_ops.resolve(
            reg[RS.FINAL_COLOR], history, motion, depth,
            ctx.cam.jitter, ctx.cam.prev_jitter,
            history_valid=ctx.history_valid,
            enabled=bool(settings.flags & RenderFlags.TAA))
        return {RS.TAA_OUTPUT: out}

    reads = (RS.FINAL_COLOR, "History_" + RS.TAA_OUTPUT) if use_gbuffer \
        else (RS.FINAL_COLOR, RS.MOTION, RS.DEPTH,
              "History_" + RS.TAA_OUTPUT)
    return fn, reads, (RS.TAA_OUTPUT,), {RS.TAA_OUTPUT: RS.TAA_OUTPUT}


# ---------------------------------------------------------------------------
# Post-process (PostProcessPass, postprocess.frag)
# ---------------------------------------------------------------------------

def make_postprocess_pass(settings, input_name):
    def fn(reg, ctx: FrameContext):
        return {RS.RENDER_OUTPUT: post_ops.tonemap(reg[input_name][..., :3],
                                                   ctx.params.exposure)}

    return fn, (input_name,), (RS.RENDER_OUTPUT,), {}


def make_skybox_pass(settings):
    """SkyboxPass (SkyboxPass.cpp:9-31 / postprocess/skybox.frag:8-26):
    standalone fullscreen sky write into FinalColor — unused by the
    reference's default paths (sky is composited in composition.frag /
    forward.frag instead), kept as the same demo. Directions are
    reconstructed at the far plane (reversed-Z 0.0, skybox.frag:17-19).
    Delta vs the reference: with no sky texture it falls back to the
    procedural gradient (miss.rmiss semantics) rather than the UBO
    clear color — our sky module's one no-texture story."""

    def fn(reg, ctx: FrameContext):
        H, W = settings.height, settings.width
        cam = ctx.cam
        uv = img_ops.pixel_uv_grid(H, W)
        ndc = jnp.concatenate(
            [uv * 2.0 - 1.0, jnp.zeros((H, W, 1)), jnp.ones((H, W, 1))], -1)
        far_h = maths.mm(ndc, cam.view_proj_inverse.T)
        far_pt = far_h[..., :3] / jnp.where(
            jnp.abs(far_h[..., 3:4]) < 1e-12, 1e-12, far_h[..., 3:4])
        direction = maths.normalize(far_pt - cam.position)
        rgb = sky.sample_environment(
            direction, ctx.scene.sky_texture, ctx.scene.textures,
            bool(settings.flags & RenderFlags.IBL),
            has_sky=ctx.scene.has_sky_texture)
        return {RS.FINAL_COLOR: rgb}

    return fn, (), (RS.FINAL_COLOR,), {}


# ---------------------------------------------------------------------------
# SVGF chains (SVGFPass compound)
# ---------------------------------------------------------------------------

def make_svgf_chain(settings, config: svgf_ops.SVGFConfig, input_name,
                    output_name):
    """One SVGF signal chain; history keys are '<prefix>' and
    '<prefix>Moments' (SVGFPass.cpp naming)."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        hist_sig = ctx.state.get(config.prefix)
        hist_mom = ctx.state.get(config.prefix + "Moments")
        if hist_sig is None or not ctx.history_valid:
            hist = svgf_ops.SVGFSignalHistory.create(settings.height,
                                                     settings.width)
            hist_ok = False
        else:
            hist = svgf_ops.SVGFSignalHistory(signal=hist_sig,
                                              moments=hist_mom)
            hist_ok = True

        prev_normal = ctx.state.get(RS.NORMAL, gb.normal)
        prev_motion = ctx.state.get(RS.MOTION, gb.motion_plane())
        prev_oid = ctx.state.get(RS.OBJECT_ID, gb.object_id)

        signal = reg[input_name]
        if signal.shape[-1] == 3:
            signal = jnp.concatenate(
                [signal, jnp.ones_like(signal[..., :1])], axis=-1)

        out, new_hist, var_dbg = svgf_ops.denoise(
            signal, gb.albedo, gb.motion_plane(), gb.normal, gb.object_id,
            hist, prev_normal, prev_motion[..., 2], prev_oid,
            config, ctx.params.svgf_phi,
            history_valid=ctx.history_valid and hist_ok)
        return {
            output_name: out,
            config.prefix + "_HistSignal": new_hist.signal,
            config.prefix + "_HistMoments": new_hist.moments,
            config.prefix + "_Variance": var_dbg,
        }

    reads = (input_name, "_GBuffer")
    writes = (output_name, config.prefix + "_HistSignal",
              config.prefix + "_HistMoments", config.prefix + "_Variance")
    history = {config.prefix + "_HistSignal": config.prefix,
               config.prefix + "_HistMoments": config.prefix + "Moments"}
    return fn, reads, writes, history


def make_svgf_multi_pass(settings, chains):
    """All active SVGF signal chains as ONE pass (svgf.denoise_multi).

    ``chains``: [(SVGFConfig, input_name, output_name)]. Per-signal
    semantics match make_svgf_chain exactly (equality-pinned by
    tests/test_denoise.py); the fused pass shares the temporal
    reprojection sweep and the stencil edge stack across signals —
    the batched analog of the reference's 3× SVGFPass::Add
    (HybridRenderPath.cpp:57-87)."""

    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        prev_normal = ctx.state.get(RS.NORMAL, gb.normal)
        prev_motion = ctx.state.get(RS.MOTION, gb.motion_plane())
        prev_oid = ctx.state.get(RS.OBJECT_ID, gb.object_id)

        signals, histories, configs, all_ok = [], [], [], True
        for config, input_name, _ in chains:
            hist_sig = ctx.state.get(config.prefix)
            hist_mom = ctx.state.get(config.prefix + "Moments")
            if hist_sig is None or not ctx.history_valid:
                hist = svgf_ops.SVGFSignalHistory.create(settings.height,
                                                         settings.width)
                all_ok = False
            else:
                hist = svgf_ops.SVGFSignalHistory(signal=hist_sig,
                                                  moments=hist_mom)
            signal = reg[input_name]
            if signal.shape[-1] == 3:
                signal = jnp.concatenate(
                    [signal, jnp.ones_like(signal[..., :1])], axis=-1)
            signals.append(signal)
            histories.append(hist)
            configs.append(config)

        results = svgf_ops.denoise_multi(
            signals, gb.albedo, gb.motion_plane(), gb.normal, gb.object_id,
            histories, prev_normal, prev_motion[..., 2], prev_oid,
            configs, ctx.params.svgf_phi,
            history_valid=ctx.history_valid and all_ok)

        out = {}
        for (config, _, output_name), (res, new_hist, var_dbg) in zip(
                chains, results):
            out[output_name] = res
            out[config.prefix + "_HistSignal"] = new_hist.signal
            out[config.prefix + "_HistMoments"] = new_hist.moments
            out[config.prefix + "_Variance"] = var_dbg
        return out

    reads = tuple(dict.fromkeys(
        [c[1] for c in chains] + ["_GBuffer"]))
    writes, history = [], {}
    for config, _, output_name in chains:
        writes += [output_name, config.prefix + "_HistSignal",
                   config.prefix + "_HistMoments",
                   config.prefix + "_Variance"]
        history[config.prefix + "_HistSignal"] = config.prefix
        history[config.prefix + "_HistMoments"] = config.prefix + "Moments"
    return fn, reads, tuple(writes), history


# ---------------------------------------------------------------------------
# Composition (CompositionPass, composition.frag)
# ---------------------------------------------------------------------------

def make_composition_pass(settings, shadow_name, gi_name, refl_name,
                          variance_name=None):
    def fn(reg, ctx: FrameContext):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        ones = jnp.ones((H, W, 2), jnp.float32)
        zeros3 = jnp.zeros((H, W, 3), jnp.float32)
        shadow_ao = reg.get(shadow_name)
        shadow_ao = ones if shadow_ao is None else shadow_ao[..., :2]
        gi = reg.get(gi_name)
        gi = zeros3 if gi is None else gi[..., :3]
        refl = reg.get(refl_name)
        refl = zeros3 if refl is None else refl[..., :3]
        var = reg.get(variance_name) if variance_name else None
        out = comp_ops.compose(gb, shadow_ao, gi, refl, ctx.scene, ctx.cam,
                               settings, ctx.params, svgf_variance=var)
        return {RS.FINAL_COLOR: out}

    reads = ("_GBuffer",)
    return fn, reads, (RS.FINAL_COLOR,), {}
