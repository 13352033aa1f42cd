"""Final lighting composition (composition.frag port, linear-HDR output).

Recombines G-buffer + (denoised) RT signals exactly as
composition.frag:95-117:
  direct  = EvalPbr(albedo, 1.5, rough, metal, N, V, L) * shadow * sunIntensity
  indirect diffuse  = GI * albedo * kD          (or ambient*albedo*AO*0.1
                                                 when GI disabled)
  indirect specular = reflection * F
  + emissive

Display modes (composition.frag:78-93) return intermediate signals.
Deviation: no exposure/gamma here (single application in postprocess —
see ops/postprocess.py docstring).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import maths
from ..core.types import DisplayMode, RenderFlags
from . import image as img_ops
from . import shade, sky


def compose(gb, shadow_ao, gi, reflection, scene, cam, settings, params,
            svgf_variance=None):
    """Args:
      gb: GBuffer
      shadow_ao: (H, W, 2+) — R: shadow factor, G: rt AO (rt_shadow.rgen packing)
      gi: (H, W, 3) diffuse GI irradiance
      reflection: (H, W, 3) specular reflection radiance
      settings: RenderSettings (static flags/display mode)
      params: FrameParams (sun/exposure/ambient — traced)
    Returns linear HDR (H, W, 3).
    """
    H, W = gb.depth.shape
    flags = settings.flags
    mode = settings.display_mode
    bg = gb.background

    # Background: sky or black (composition.frag:43-57)
    uv = img_ops.pixel_uv_grid(H, W)
    ndc = jnp.concatenate([uv * 2.0 - 1.0, jnp.zeros((H, W, 2))], axis=-1)
    # view ray direction through each pixel at far plane (z_ndc = 0)
    world_h = maths.mm(ndc.at[..., 3].set(1.0), cam.view_proj_inverse.T)
    far_point = world_h[..., :3] / jnp.where(
        jnp.abs(world_h[..., 3:4]) < 1e-12, 1e-12, world_h[..., 3:4])
    view_dir = maths.normalize(far_point - cam.position)
    sky_rgb = sky.sample_environment(
        view_dir, scene.sky_texture, scene.textures,
        ibl_enabled=bool(flags & RenderFlags.IBL),
        has_sky=scene.has_sky_texture)

    # Debug display modes
    if mode == DisplayMode.ALBEDO:
        return jnp.where(bg[..., None], 0.0, gb.albedo)
    if mode == DisplayMode.NORMAL:
        out = gb.normal * 0.5 + 0.5
        return jnp.where(bg[..., None], jnp.array([0.15, 0.15, 0.15]), out)
    if mode == DisplayMode.MATERIAL:
        return jnp.where(bg[..., None], jnp.array([0.15, 0.15, 0.15]),
                         gb.material[..., :3])
    if mode == DisplayMode.DEPTH:
        v = 1.0 / (gb.linear_depth * 0.1 + 1.0)
        return jnp.where(bg[..., None], 0.0, v[..., None] * jnp.ones(3))
    if mode == DisplayMode.MOTION:
        m = jnp.abs(gb.motion) * 10.0
        return jnp.concatenate([m, jnp.zeros((H, W, 1))], axis=-1)
    if mode == DisplayMode.SHADOW:
        return shadow_ao[..., 0:1] * jnp.ones(3)
    if mode == DisplayMode.AO:
        return shadow_ao[..., 1:2] * jnp.ones(3)
    if mode == DisplayMode.GI:
        return gi
    if mode == DisplayMode.REFLECTION:
        return reflection
    if mode == DisplayMode.EMISSIVE:
        return gb.emissive
    if mode == DisplayMode.SVGF_VARIANCE and svgf_variance is not None:
        return svgf_variance[..., None] * jnp.ones(3)

    # Physically-based recombination
    base = gb.albedo
    n = maths.normalize(jnp.where(bg[..., None], jnp.array([0.0, 1.0, 0.0]),
                                  gb.normal))
    rough = gb.material[..., 0]
    metal = gb.material[..., 1]
    v = maths.normalize(cam.position - gb.world_pos)
    l = maths.normalize(-params.sun_direction)

    light_on = bool(flags & RenderFlags.LIGHT)
    intensity = params.sun_color * params.sun_intensity if light_on else \
        jnp.zeros((3,), jnp.float32)

    shadow = shadow_ao[..., 0]
    rt_ao = shadow_ao[..., 1]

    direct = shade.eval_pbr(base, 1.5, rough, metal, n, v, l) * \
        shadow[..., None] * intensity

    f0 = maths.mix(jnp.full_like(base, 0.04), base, metal[..., None])
    f = shade.fresnel_schlick(f0, n, v)
    kd = (1.0 - f) * (1.0 - metal[..., None])
    if flags & RenderFlags.GI:
        indirect_diffuse = gi * base * kd
    else:
        indirect_diffuse = params.ambient_strength * base * \
            rt_ao[..., None] * 0.1
    indirect_specular = reflection * f

    out = direct + indirect_diffuse + indirect_specular + gb.emissive
    return jnp.where(bg[..., None], sky_rgb, out)
