"""Temporal anti-aliasing resolve (taa.comp port).

Full pipeline of taa.comp: 3×3 velocity dilation toward the closest
reversed-Z depth (:83-93), jitter-compensated reprojection (:95-103),
YCoCg + firefly-suppressing tonemap (:14-46), variance neighborhood AABB
(:109-131) with ray-box history clipping (:49-67), motion-adaptive alpha
0.1–0.9 (:141-145) and the history-availability gate (:147-149).
"""
from __future__ import annotations

import jax.numpy as jnp

from . import image as img_ops


def _rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return jnp.stack(
        [0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
         -0.25 * r + 0.5 * g - 0.25 * b], axis=-1)


def _ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return jnp.stack([y + co - cg, y + cg, y - co - cg], axis=-1)


def _tonemap(c):
    c = jnp.where(jnp.isfinite(c), c, 0.0)
    c = jnp.maximum(c, 0.0)
    return c / (1.0 + jnp.max(c, axis=-1, keepdims=True))


def _untonemap(c):
    lum = jnp.max(c, axis=-1, keepdims=True)
    return c / jnp.maximum(1.0 - lum, 0.0001)


def _clip_history(history, box_min, box_max):
    """Ray-box clip of history toward the box center (taa.comp:49-67)."""
    filtered = (box_min + box_max) * 0.5
    ray_dir = filtered - history
    ray_dir = jnp.where(jnp.abs(ray_dir) < 1e-5, 1e-5, ray_dir)
    inv = 1.0 / ray_dir
    t_min = (box_min - history) * inv
    t_max = (box_max - history) * inv
    enter = jnp.minimum(t_min, t_max)
    t = jnp.clip(jnp.max(enter, axis=-1, keepdims=True), 0.0, 1.0)
    return history + (filtered - history) * t


def resolve(cur_color, history_color, motion, depth, jitter, prev_jitter,
            history_valid: bool, enabled: bool = True):
    """TAA resolve. ``motion`` is the G-buffer (H,W,2) uv motion; ``depth``
    reversed-Z; jitters in NDC units (jitterData convention: ×0.5 → uv).

    ``history_valid``/``enabled`` are static (the reference's
    TAA_HISTORY/TAA flag bits resolved at trace time). History is
    fetched with a per-pixel bilinear gather.
    """
    if not enabled:
        return cur_color

    H, W = depth.shape
    uv = img_ops.pixel_uv_grid(H, W)

    # 1. velocity dilation: motion of the 3×3-closest pixel (max reversed-Z)
    best_d = None
    best_motion = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = img_ops.shift(depth, dy, dx)
            m = img_ops.shift(motion, dy, dx)
            if best_d is None:
                best_d, best_motion = d, m
            else:
                take = (d > best_d)[..., None]
                best_motion = jnp.where(take, m, best_motion)
                best_d = jnp.maximum(d, best_d)

    # 2. reprojection with jitter compensation (taa.comp:96-103)
    cur_j = jitter * 0.5
    prev_j = prev_jitter * 0.5
    unjittered_uv = uv - cur_j
    prev_uv = unjittered_uv - best_motion + prev_j

    cur_ycocg = _rgb_to_ycocg(_tonemap(cur_color))

    # 3. neighborhood statistics AABB
    m1 = jnp.zeros_like(cur_ycocg)
    m2 = jnp.zeros_like(cur_ycocg)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = _rgb_to_ycocg(_tonemap(img_ops.shift(cur_color, dy, dx)))
            m1 = m1 + c
            m2 = m2 + c * c
    mu = m1 / 9.0
    sigma = jnp.sqrt(jnp.maximum(m2 / 9.0 - mu * mu, 0.0))
    box_min = mu - 1.5 * sigma
    box_max = mu + 1.5 * sigma

    # 4. sample + clip history
    off = (
        (prev_uv[..., 0] < 0.0) | (prev_uv[..., 0] > 1.0)
        | (prev_uv[..., 1] < 0.0) | (prev_uv[..., 1] > 1.0)
    )[..., None]
    history = img_ops.sample_bilinear(history_color, prev_uv)
    hist_ycocg = _clip_history(_rgb_to_ycocg(_tonemap(history)),
                               box_min, box_max)

    # 5. motion-adaptive blend
    size = jnp.array([W, H], jnp.float32)
    motion_len = jnp.linalg.norm(best_motion * size, axis=-1)
    alpha = jnp.clip(0.1 + motion_len * 0.1, 0.1, 0.9)[..., None]
    alpha = jnp.where(off, 1.0, alpha)
    if not history_valid:
        alpha = jnp.ones_like(alpha)

    resolved = hist_ycocg + (cur_ycocg - hist_ycocg) * alpha
    return _untonemap(_ycocg_to_rgb(resolved))
