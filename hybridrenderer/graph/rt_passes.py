"""Ray-tracing passes (RTShadowPass / RTReflectionPass / RTDiffuseGIPass /
RaytracePass) over the frame context's trace hooks.

The hooks are provided by the runtime once a ray tracer is attached
(ops/bvh + ops/trace); without them passes emit neutral signals —
mirroring the reference's graceful RT-unsupported fallback
(HybridRenderPath.cpp:44-47, VulkanDevice.cpp:103-116).
"""
from __future__ import annotations

import os

import jax.numpy as jnp

from ..core import maths
from ..core.types import RenderFlags
from ..ops import image as img_ops
from ..ops import sampling, sky
from .params import RS


def _reconstruct_dirs(gb, cam):
    v = maths.normalize(gb.world_pos - cam.position)
    return v


def make_rt_shadow_pass(settings):
    """RTShadowPass (rt_shadow.rgen): packed (shadow, AO) 1-spp signal via
    NEE light sampling + cosine-hemisphere AO, both through the visibility
    query hook."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        out = jnp.ones((H, W, 4), jnp.float32)
        if ctx.shadow_query is None:
            return {RS.CUR_COLOR: out.at[..., 2].set(0.0)}

        sc, params = ctx.scene, ctx.params
        n = gb.normal
        bg = gb.background

        # per-pixel seeds (rt_shadow.rgen:53)
        ys = jnp.arange(H, dtype=jnp.uint32)[:, None]
        xs = jnp.arange(W, dtype=jnp.uint32)[None, :]
        pixel_idx = ys * jnp.uint32(W) + xs
        seed = sampling.init_random_seed(pixel_idx, params.frame_index)

        shadow = jnp.ones((H, W), jnp.float32)
        l = None
        if settings.flags & RenderFlags.SHADOW:
            ldir, sampled_inst, seed = sampling.sample_lights(
                sc, gb.world_pos, seed)
            has_area = maths.length(ldir) > 0.01
            sun_dir = maths.normalize(-params.sun_direction)
            l = jnp.where(has_area[..., None], ldir,
                          jnp.broadcast_to(sun_dir, ldir.shape))

        # fused shadow+AO dispatch (RT_FUSE_SHADOW_AO): both queries
        # share origins and the tile layout; one traversal with per-ray
        # tMax replaces two dispatches
        fuse = (os.environ.get("RT_FUSE_SHADOW_AO", "0") == "1"
                and l is not None
                and (settings.flags & RenderFlags.AO)
                and settings.ao_interleaved
                and settings.ao_layout == "tile"
                and ctx.shadow_query_pair is not None)
        if fuse:
            ao_dir = sampling.interleaved_cos_hemisphere(
                params.frame_index, n, block=settings.ao_block)
            shadow, ao = ctx.shadow_query_pair(
                gb.world_pos, n, l, 1e10, ao_dir, settings.ao_radius,
                active=~bg)
            shadow = jnp.where(bg, 1.0, shadow)
            ao = jnp.where(bg, 1.0, ao)
            return {RS.CUR_COLOR: jnp.stack(
                [shadow, ao, jnp.zeros_like(ao), jnp.ones_like(ao)],
                axis=-1)}
        if l is not None:
            shadow = ctx.shadow_query(gb.world_pos, n, l, 1e10,
                                      active=~bg)

        ao = jnp.ones((H, W), jnp.float32)
        if settings.flags & RenderFlags.AO:

            def trace_ao(nrm, wpos, bgm, hh, ww, sd=None):
                if settings.ao_interleaved:
                    ao_dir = sampling.interleaved_cos_hemisphere(
                        params.frame_index, nrm, block=settings.ao_block)
                    return ctx.shadow_query(wpos, nrm, ao_dir,
                                            settings.ao_radius, active=~bgm,
                                            layout=settings.ao_layout)
                if settings.use_blue_noise:
                    bn = sampling.blue_noise_uniforms(
                        sc.blue_noise, params.frame_index, hh, ww)
                    ao_dir = sampling.cos_hemisphere_from_uniforms(
                        bn[..., 0], bn[..., 1], nrm)
                else:
                    if sd is None:
                        # half-res grid draws its own per-pixel seeds
                        yh = jnp.arange(hh, dtype=jnp.uint32)[:, None]
                        xh = jnp.arange(ww, dtype=jnp.uint32)[None, :]
                        sd = sampling.init_random_seed(
                            yh * jnp.uint32(ww) + xh, params.frame_index)
                    ao_dir, _ = sampling.cos_hemisphere_sample(sd, nrm)
                return ctx.shadow_query(wpos, nrm, ao_dir,
                                        settings.ao_radius, active=~bgm)

            # full res continues the light-sampling seed stream
            # (rt_shadow.rgen:53 semantics)
            ao = trace_ao(n, gb.world_pos, bg, H, W, sd=seed)

        shadow = jnp.where(bg, 1.0, shadow)
        ao = jnp.where(bg, 1.0, ao)
        return {RS.CUR_COLOR: jnp.stack(
            [shadow, ao, jnp.zeros_like(ao), jnp.ones_like(ao)], axis=-1)}

    return fn, ("_GBuffer",), (RS.CUR_COLOR,), {}


def make_rt_reflection_pass(settings):
    """RTReflectionPass (reflection.rgen): mirror rays below the roughness
    cutoff, shaded by the closest-hit radiance hook."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        zeros = jnp.zeros((H, W, 4), jnp.float32)
        if ctx.trace_radiance is None:
            return {RS.REFLECTION_RAW: zeros}

        n = gb.normal
        v = _reconstruct_dirs(gb, ctx.cam)
        refl_dir = maths.reflect(v, n)
        origin = sampling.offset_ray(gb.world_pos, n)
        rough = gb.material[..., 0]
        cut = (rough > settings.reflection_roughness_cutoff) | gb.background
        if settings.reflection_half_res:
            rad_h, _ = ctx.trace_radiance(
                origin[::2, ::2], refl_dir[::2, ::2], ctx, 0,
                active=~cut[::2, ::2])
            radiance = img_ops.upsample2x_depth_aware(
                rad_h, gb.linear_depth[::2, ::2], gb.linear_depth)
        else:
            # active mask: rays above the roughness cutoff are zeroed
            # below anyway — skip their traversals entirely
            radiance, _dist = ctx.trace_radiance(origin, refl_dir, ctx, 0,
                                                 active=~cut)
        rgb = jnp.where(cut[..., None], 0.0, radiance)
        return {RS.REFLECTION_RAW: jnp.concatenate(
            [rgb, jnp.ones((H, W, 1), jnp.float32)], axis=-1)}

    return fn, ("_GBuffer",), (RS.REFLECTION_RAW,), {}


def make_rt_gi_pass(settings):
    """RTDiffuseGIPass (diffuse_gi.rgen): 1-spp cosine-hemisphere bounce."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        zeros = jnp.zeros((H, W, 4), jnp.float32)
        if ctx.trace_radiance is None:
            return {RS.GI_RAW: zeros}

        params = ctx.params

        def trace_gi(nrm, wpos, bgm, hh, ww, block):
            layout = "tile"
            if settings.gi_interleaved:
                # one bounce direction per 8×8 block pattern per frame
                # (the AO sampler, salted to decorrelate) — direction-
                # coherent rays
                ray_dir = sampling.interleaved_cos_hemisphere(
                    params.frame_index, nrm, block=block,
                    salt=0x7D1E6100)
                layout = settings.gi_layout
            elif settings.use_blue_noise:
                # blue-noise 1-spp draws (raygen.rgen:29-31 semantics);
                # zw channels so the GI bounce decorrelates from AO
                bn = sampling.blue_noise_uniforms(
                    ctx.scene.blue_noise, params.frame_index, hh, ww)
                ray_dir = sampling.cos_hemisphere_from_uniforms(
                    bn[..., 2], bn[..., 3], nrm)
            else:
                ys = jnp.arange(hh, dtype=jnp.uint32)[:, None]
                xs = jnp.arange(ww, dtype=jnp.uint32)[None, :]
                seed = sampling.init_random_seed(ys * jnp.uint32(ww) + xs,
                                                 params.frame_index)
                ray_dir, _ = sampling.cos_hemisphere_sample(seed, nrm)
            origin = sampling.offset_ray(wpos, nrm)
            rad, _ = ctx.trace_radiance(origin, ray_dir, ctx, 0,
                                        active=~bgm, layout=layout)
            return rad

        if settings.gi_half_res:
            # halve the interleave block so each direction block covers
            # the SAME full-res screen area as at full res — without
            # this the half-res grid doubles the block footprint and the
            # converged image drifts (CPU probe r4: mean err 21.7 at
            # block 32 → 2.6 at block 16 vs the full-res render)
            rad_h = trace_gi(gb.normal[::2, ::2], gb.world_pos[::2, ::2],
                             gb.background[::2, ::2],
                             (H + 1) // 2, (W + 1) // 2,
                             max(settings.gi_block // 2, 2))
            radiance = img_ops.upsample2x_depth_aware(
                rad_h, gb.linear_depth[::2, ::2], gb.linear_depth)
        else:
            radiance = trace_gi(gb.normal, gb.world_pos, gb.background,
                                H, W, settings.gi_block)
        rgb = jnp.where(gb.background[..., None], 0.0, radiance)
        return {RS.GI_RAW: jnp.concatenate(
            [rgb, jnp.ones((H, W, 1), jnp.float32)], axis=-1)}

    return fn, ("_GBuffer",), (RS.GI_RAW,), {}


def make_primary_rt_pass(settings):
    """RaytracePass (raytrace.rgen): primary camera rays → FinalColor +
    Motion. Motion is camera-reprojection of the hit point
    (raytrace.rgen:60-66 semantics; the reference's closest-hit also
    folds in per-instance prevTransform, closesthit.rchit:118-127 —
    object motion in the pure-RT path is not reconstructed here and
    TAA sees camera motion only)."""

    def fn(reg, ctx):
        H, W = settings.height, settings.width
        cam = ctx.cam
        uv = img_ops.pixel_uv_grid(H, W)
        ndc = jnp.concatenate(
            [uv * 2.0 - 1.0, jnp.zeros((H, W, 1)), jnp.ones((H, W, 1))], -1)
        far_h = maths.mm(ndc, cam.view_proj_inverse.T)
        far_pt = far_h[..., :3] / jnp.where(
            jnp.abs(far_h[..., 3:4]) < 1e-12, 1e-12, far_h[..., 3:4])
        direction = maths.normalize(far_pt - cam.position)
        origin = jnp.broadcast_to(cam.position, direction.shape)

        motion = jnp.zeros((H, W, 4), jnp.float32)
        if ctx.trace_radiance is None:
            rgb = sky.sample_environment(
                direction, ctx.scene.sky_texture, ctx.scene.textures,
                bool(settings.flags & RenderFlags.IBL),
                has_sky=ctx.scene.has_sky_texture)
        else:
            rgb, dist = ctx.trace_radiance(origin, direction, ctx, 0)
            hit = jnp.isfinite(dist)
            d_safe = jnp.where(hit, dist, 1.0)[..., None]
            world = origin + direction * d_safe
            wh = jnp.concatenate([world, jnp.ones((H, W, 1))], -1)
            prev_vp = maths.mm(jnp.asarray(cam.prev_proj),
                               jnp.asarray(cam.prev_view))
            cur_vp = maths.mm(jnp.asarray(cam.proj), jnp.asarray(cam.view))

            def to_uv(clip):
                w = jnp.where(jnp.abs(clip[..., 3:4]) < 1e-12, 1e-12,
                              clip[..., 3:4])
                return (clip[..., :2] / w) * 0.5 + 0.5

            mv = to_uv(maths.mm(wh, cur_vp.T)) \
                - to_uv(maths.mm(wh, prev_vp.T))
            lin_z = jnp.where(hit, dist, 0.0)
            motion = jnp.concatenate(
                [jnp.where(hit[..., None], mv, 0.0), lin_z[..., None],
                 jnp.zeros((H, W, 1))], -1)
        return {RS.FINAL_COLOR: rgb, RS.MOTION: motion}

    return fn, (), (RS.FINAL_COLOR, RS.MOTION), {}


# ---------------------------------------------------------------------------
# Demo passes (unused by the default paths in the reference too)
# ---------------------------------------------------------------------------

def make_rtao_pass(settings):
    """RTAOPass (RTAOPass.cpp:11-31 / rt_ao.rgen:11-48): standalone 1-spp
    cosine-hemisphere AO at a fixed 2-unit radius, written to its own
    AORaw plane. The default hybrid path packs AO with shadow inside
    RTShadowPass instead — this is the reference's AO-only demo.
    Background pixels get 1.0 (rt_ao.rgen:17-20); visibility semantics
    match the rgen's terminate-on-first-hit + miss-shader flip."""

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        H, W = gb.depth.shape
        ones = jnp.ones((H, W), jnp.float32)
        if ctx.shadow_query is None:
            ao = ones
        else:
            params = ctx.params
            ys = jnp.arange(H, dtype=jnp.uint32)[:, None]
            xs = jnp.arange(W, dtype=jnp.uint32)[None, :]
            seed = sampling.init_random_seed(ys * jnp.uint32(W) + xs,
                                             params.frame_index)
            ao_dir, _ = sampling.cos_hemisphere_sample(seed, gb.normal)
            ao = ctx.shadow_query(gb.world_pos, gb.normal, ao_dir, 2.0,
                                  active=~gb.background)
            ao = jnp.where(gb.background, 1.0, ao)
        zeros = jnp.zeros_like(ao)
        return {RS.AO_RAW: jnp.stack([ao, zeros, zeros,
                                      jnp.ones_like(ao)], axis=-1)}

    return fn, ("_GBuffer",), (RS.AO_RAW,), {}


def make_rayquery_pass(settings):
    """RayQueryPass (RayQueryPass.cpp:18-50 / rayquery.frag:16-56): the
    forward-raster + per-fragment ray-query-shadow demo. Deferred
    formulation over the G-buffer; the demo's deltas vs ForwardPass are
    kept faithful: the shadow origin offsets along the screen-space FACE
    normal (dFdx x dFdy, rayquery.frag:26-30), the query runs to tMax
    10000 (rayquery.frag:33), and it runs unconditionally when a tracer
    is wired (no SHADOW flag gate)."""
    from ..ops import shade

    def fn(reg, ctx):
        gb = reg["_GBuffer"]
        sc, cam, params = ctx.scene, ctx.cam, ctx.params
        bg = gb.background
        n = maths.normalize(jnp.where(bg[..., None],
                                      jnp.array([0.0, 1.0, 0.0]),
                                      gb.normal))
        v = maths.normalize(cam.position - gb.world_pos)
        l = maths.normalize(-params.sun_direction)
        intensity = params.sun_color * params.sun_intensity

        # dFdx/dFdy face normal (rayquery.frag:26-29), deferred analog
        ddx = jnp.diff(gb.world_pos, axis=1, append=gb.world_pos[:, -1:])
        ddy = jnp.diff(gb.world_pos, axis=0, append=gb.world_pos[-1:, :])
        face_n = maths.normalize(maths.cross(ddx, ddy))
        flip = maths.dot(face_n, v, keepdims=True) < 0.0
        face_n = jnp.where(flip, -face_n, face_n)

        if ctx.shadow_query is not None:
            shadow = ctx.shadow_query(
                gb.world_pos, face_n,
                jnp.broadcast_to(l, gb.world_pos.shape), 10000.0,
                active=~bg)
        else:
            shadow = jnp.ones_like(gb.depth)

        rough = gb.material[..., 0]
        metal = gb.material[..., 1]
        direct = shade.eval_pbr(gb.albedo, 1.5, rough, metal, n, v, l) \
            * shadow[..., None] * intensity

        # ambient: IBL when a sky texture exists, else flat
        # (rayquery.frag:40-53 gates on skyboxIdx >= 0)
        if sc.has_sky_texture:
            r = maths.reflect(-v, n)
            env_spec = sky.sample_environment(r, sc.sky_texture,
                                              sc.textures, True,
                                              sc.has_sky_texture)
            env_diff = sky.sample_environment(n, sc.sky_texture,
                                              sc.textures, True,
                                              sc.has_sky_texture)
            f0 = maths.mix(jnp.full_like(gb.albedo, 0.04), gb.albedo,
                           metal[..., None])
            f = shade.fresnel_schlick(f0, n, v)
            kd = (1.0 - f) * (1.0 - metal[..., None])
            ambient = (kd * env_diff * gb.albedo + f * env_spec) \
                * params.ambient_strength
        else:
            ambient = params.ambient_strength * gb.albedo

        color = ambient + direct + gb.emissive
        color = jnp.where(bg[..., None], 0.0, color)
        return {RS.FINAL_COLOR: color}

    return fn, ("_GBuffer",), (RS.FINAL_COLOR,), {}
