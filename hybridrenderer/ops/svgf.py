"""SVGF denoiser — temporal accumulation + variance-guided à-trous filtering.

Faithful port of the five compute kernels (shaders/postprocess/svgf/):
  temporal.comp       — ID/normal/depth-validated bilinear reprojection,
                        EMA with history length ≤ 32, albedo demodulation
  filter_moments.comp — 7×7 joint-bilateral variance estimate with <4-frame
                        variance boost
  variance_blur.comp  — 3×3 blur/max hybrid variance smear
  atrous.comp         — 5×5 edge-stopping à-trous, steps 1,2,4…; variance
                        filtered with w²
  combine.comp        — albedo re-modulation

Chaining matches SVGFPass::Add (SVGFPass.cpp:177-234): the *first* à-trous
output becomes next frame's temporal history signal, temporal moments are
their own history. Signals are (H, W, 4): rgb + (variance in .a after the
moments stage). Geometry inputs use the G-buffer's motion plane
(motion.xy, linZ, ∂z/∂x).

Edge-stopping constants come from FrameParams.svgf_phi; defaults reproduce
the shaders' indexing of svgfPhi = (4.0, 128.0, 0.02, 0): phiLuma(moments)
= .x, phiLuma(atrous) scale = .y, normal power = .z — note the reference
UBO comment labels these differently (Application.cpp:362-367) but the
shaders index as implemented here; we match shader behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from . import image as img_ops
from .shade import luminance


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SVGFSignalHistory:
    """Per-signal carried state (the History_* images of the reference)."""

    signal: Any   # (H, W, 4) first-atrous output of previous frame
    moments: Any  # (H, W, 4) (m1, m2, var, historyLen)

    @staticmethod
    def create(height, width):
        return SVGFSignalHistory(
            signal=jnp.zeros((height, width, 4), jnp.float32),
            moments=jnp.zeros((height, width, 4), jnp.float32),
        )


def temporal(cur_signal, albedo, motion_plane, normal, object_id,
             history: SVGFSignalHistory,
             prev_normal, prev_lin_depth, prev_object_id,
             use_albedo_demod: bool, history_valid: bool):
    """temporal.comp: returns (accumulated signal (H,W,4), moments (H,W,4)).

    Single-signal wrapper over temporal_multi."""
    (out,) = temporal_multi(
        [cur_signal], albedo, motion_plane, normal, object_id, [history],
        prev_normal, prev_lin_depth, prev_object_id, [use_albedo_demod],
        history_valid)
    return out


def temporal_multi(cur_signals, albedo, motion_plane, normal, object_id,
                   histories, prev_normal, prev_lin_depth, prev_object_id,
                   demod_flags, history_valid: bool):
    """temporal.comp for K signals sharing one motion/geometry frame —
    returns [(accumulated signal (H,W,4), moments (H,W,4))]×K.

    The footprint bases, bilinear weights, and is_valid_reprojection
    tests depend only on motion and the previous-frame geometry, so they
    are computed once for every signal. Each signal's 2×2 history
    footprint is fetched with one per-pixel row gather.
    """
    H, W = object_id.shape
    uv = img_ops.pixel_uv_grid(H, W)

    motion = motion_plane[..., :2]
    cur_depth = motion_plane[..., 2]

    curs, lumas = [], []
    for cur, demod in zip(cur_signals, demod_flags):
        if demod:
            dem = jnp.maximum(albedo, 0.01)
            cur = cur.at[..., :3].set(cur[..., :3] / dem)
        curs.append(cur)
        lumas.append(luminance(cur[..., :3]))

    if not history_valid:
        outs = []
        for cur, cur_luma in zip(curs, lumas):
            m1 = cur_luma
            m2 = cur_luma * cur_luma
            moments = jnp.stack(
                [m1, m2, jnp.zeros_like(m1), jnp.ones_like(m1)], axis=-1)
            outs.append((cur, moments))
        return outs

    prev_uv = uv - motion
    # manual validated 2×2 bilinear (temporal.comp:95-113)
    prev_pix = prev_uv * jnp.array([W, H], jnp.float32) - 0.5
    # clamp the footprint base to the last full 2×2 window and re-derive
    # the fractions — identical bilinear for any on-screen sample point
    base = jnp.clip(jnp.floor(prev_pix), 0.0,
                    jnp.array([W - 2, H - 2], jnp.float32))
    f = prev_pix - base
    oid_f = object_id.astype(jnp.float32)
    bx = base[..., 0].astype(jnp.int32)
    by = base[..., 1].astype(jnp.int32)
    # the footprint must be fully on-screen (the shader's
    # partially-clipped border bilinear is treated as invalid — a 1-px
    # border difference when motion crosses the screen edge)
    footprint_ok = (prev_pix[..., 0] >= 0) & (prev_pix[..., 0] <= W - 1) \
        & (prev_pix[..., 1] >= 0) & (prev_pix[..., 1] <= H - 1)

    fetched = []  # per signal: (hist_sig, hist_mom, hist_len, weight_sum)
    # per signal: all 4 taps of the 2×2 footprint pre-packed into
    # 48-float rows so the whole bilinear footprint is ONE row gather
    def validate(row, nrm, z, oid):
        # is_valid_reprojection (temporal.comp:45-62)
        ok = row[..., 11] == oid
        ok = ok & (jnp.sum(row[..., 7:10] * nrm, axis=-1) >= 0.95)
        ok = ok & (jnp.abs(z - row[..., 10]) / (z + 1e-6) <= 0.05)
        return ok

    weights = [
        (1 - f[..., 0]) * (1 - f[..., 1]), f[..., 0] * (1 - f[..., 1]),
        (1 - f[..., 0]) * f[..., 1], f[..., 0] * f[..., 1],
    ]
    for history in histories:
        hpack = jnp.concatenate([
            history.signal.astype(jnp.float32),        # 0:4
            history.moments[..., :2].astype(jnp.float32),   # 4:6
            history.moments[..., 3:4].astype(jnp.float32),  # 6
            prev_normal,                               # 7:10
            prev_lin_depth[..., None],                 # 10
            prev_object_id[..., None].astype(jnp.float32),  # 11
        ], axis=-1)
        right = jnp.concatenate([hpack[:, 1:], hpack[:, -1:]], axis=1)
        down = jnp.concatenate([hpack[1:], hpack[-1:]], axis=0)
        down_right = jnp.concatenate([right[1:], right[-1:]], axis=0)
        hpack4 = jnp.concatenate([hpack, right, down, down_right],
                                 axis=-1).reshape(H * W, 48)

        hist_sig = jnp.zeros((H, W, 4), jnp.float32)
        hist_mom = jnp.zeros((H, W, 2), jnp.float32)
        hist_len = jnp.zeros((H, W), jnp.float32)
        weight_sum = jnp.zeros((H, W), jnp.float32)
        rows4 = hpack4[by * W + bx]                    # (H, W, 48)
        for tap, w8 in enumerate(weights):
            row = rows4[..., 12 * tap:12 * tap + 12]
            ok = footprint_ok & validate(row, normal, cur_depth, oid_f)
            w_eff = jnp.where(ok, w8, 0.0)
            hist_sig = hist_sig + w_eff[..., None] * row[..., 0:4]
            hist_mom = hist_mom + w_eff[..., None] * row[..., 4:6]
            hist_len = hist_len + w_eff * row[..., 6]
            weight_sum = weight_sum + w_eff
        fetched.append((hist_sig, hist_mom, hist_len, weight_sum))

    outs = []
    for cur, cur_luma, (hist_sig, hist_mom, hist_len, weight_sum) in zip(
            curs, lumas, fetched):
        valid = weight_sum > 0.01
        ws = jnp.maximum(weight_sum, 1e-6)[..., None]
        hist_sig = hist_sig / ws
        hist_mom = hist_mom / ws
        hist_len = hist_len / ws[..., 0]

        out_hlen = jnp.where(valid, jnp.minimum(32.0, hist_len + 1.0), 1.0)
        alpha = 1.0 / out_hlen

        accum = jnp.where(valid[..., None],
                          hist_sig + (cur - hist_sig) * alpha[..., None],
                          cur)
        m1 = jnp.where(
            valid, hist_mom[..., 0] + (cur_luma - hist_mom[..., 0]) * alpha,
            cur_luma)
        m2 = jnp.where(
            valid,
            hist_mom[..., 1] + (cur_luma * cur_luma - hist_mom[..., 1]) * alpha,
            cur_luma * cur_luma)
        var = jnp.maximum(0.0, m2 - m1 * m1)
        moments = jnp.stack([m1, m2, var, out_hlen], axis=-1)
        outs.append((accum, moments))
    return outs


def _edge_weight(depth_c, depth_p, phi_depth, normal_c, normal_p, phi_normal,
                 luma_c, luma_p, phi_luma):
    """computeWeight (filter_moments.comp:41-52 / atrous.comp:27-38)."""
    w_normal = jnp.maximum(0.0, jnp.sum(normal_c * normal_p, axis=-1)) ** phi_normal
    w_z = jnp.where(phi_depth < 1e-6, 0.0,
                    jnp.abs(depth_c - depth_p) / jnp.maximum(phi_depth, 1e-12))
    w_l = jnp.abs(luma_c - luma_p) / phi_luma
    return jnp.exp(-w_l - w_z) * w_normal


def filter_moments(signal, moments, normal, motion_plane, svgf_phi):
    """filter_moments.comp: 7×7 joint-bilateral variance estimate.

    Returns (signal rgb+var, moments with var in .b). Border handling uses
    clamp-to-edge (the shader skips out-of-bounds taps; equivalent up to a
    1-texel rim reweighting).
    """
    luma_c = luminance(signal[..., :3])
    depth_c = motion_plane[..., 2]
    depth_deriv = motion_plane[..., 3]
    hlen = moments[..., 3]

    phi_luma = svgf_phi[0]
    phi_depth_base = jnp.maximum(depth_deriv, 1e-8) * 3.0
    phi_normal = svgf_phi[2]

    sum_w = jnp.zeros_like(luma_c)
    sum_illum = jnp.zeros_like(signal[..., :3])
    sum_mom = jnp.zeros_like(moments[..., :2])
    for yy in range(-3, 4):
        for xx in range(-3, 4):
            ill_p = img_ops.shift(signal[..., :3], yy, xx)
            mom_p = img_ops.shift(moments[..., :2], yy, xx)
            depth_p = img_ops.shift(depth_c, yy, xx)
            normal_p = img_ops.shift(normal, yy, xx)
            dist = float((xx * xx + yy * yy) ** 0.5)
            w = _edge_weight(depth_c, depth_p, phi_depth_base * dist + 1e-6,
                             normal, normal_p, phi_normal,
                             luma_c, luminance(ill_p), phi_luma)
            sum_w = sum_w + w
            sum_illum = sum_illum + ill_p * w[..., None]
            sum_mom = sum_mom + mom_p * w[..., None]

    sum_w = jnp.maximum(sum_w, 1e-6)
    sum_illum = sum_illum / sum_w[..., None]
    sum_mom = sum_mom / sum_w[..., None]

    variance = jnp.maximum(0.0, sum_mom[..., 1] - sum_mom[..., 0] ** 2)
    # <4-frame variance boost (filter_moments.comp:115-118)
    variance = jnp.where(hlen < 4.0,
                         variance * (4.0 / jnp.maximum(1.0, hlen)), variance)

    # depth==0 background passthrough (filter_moments.comp:72-75)
    bg = depth_c == 0.0
    out_signal = jnp.where(bg[..., None],
                           signal,
                           jnp.concatenate([sum_illum, variance[..., None]], -1))
    out_moments = jnp.concatenate(
        [sum_mom, variance[..., None], hlen[..., None]], axis=-1)
    return out_signal, out_moments


def variance_blur(moments):
    """variance_blur.comp: 3×3 (1,2,1)² blur of variance mixed 50% with max."""
    var = moments[..., 2]
    kernel = [1.0, 2.0, 1.0]
    blurred = jnp.zeros_like(var)
    vmax = jnp.full_like(var, -jnp.inf)
    wsum = 0.0
    for yy in (-1, 0, 1):
        for xx in (-1, 0, 1):
            w = kernel[xx + 1] * kernel[yy + 1]
            v = img_ops.shift(var, yy, xx)
            blurred = blurred + v * w
            vmax = jnp.maximum(vmax, v)
            wsum += w
    mixed = 0.5 * (blurred / wsum) + 0.5 * vmax
    return moments.at[..., 2].set(mixed)


def atrous(signal, moments, normal, motion_plane, step: int, svgf_phi):
    """atrous.comp: one 5×5 à-trous iteration at the given step size.

    Variance rides in signal[..., 3] and is filtered with w².
    """
    kernel = [3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0]
    luma_c = luminance(signal[..., :3])
    var_c = signal[..., 3]
    depth_c = motion_plane[..., 2]
    depth_deriv = motion_plane[..., 3]

    phi_luma = svgf_phi[1] * jnp.sqrt(jnp.maximum(0.0, 1e-10 + var_c)) + 1e-6
    phi_depth_base = jnp.maximum(depth_deriv, 1e-8) * float(step) + 1e-6
    phi_normal = svgf_phi[2]

    w_center = kernel[0] * kernel[0]
    sum_w = jnp.full_like(luma_c, w_center)
    sum_rgb = signal[..., :3] * w_center
    sum_var = var_c * w_center

    for yy in range(-2, 3):
        for xx in range(-2, 3):
            if xx == 0 and yy == 0:
                continue
            k = kernel[abs(xx)] * kernel[abs(yy)]
            ill_p = img_ops.shift(signal, yy * step, xx * step)
            depth_p = img_ops.shift(depth_c, yy * step, xx * step)
            normal_p = img_ops.shift(normal, yy * step, xx * step)
            dist = float((xx * xx + yy * yy) ** 0.5)
            w = _edge_weight(depth_c, depth_p, phi_depth_base * dist,
                             normal, normal_p, phi_normal,
                             luma_c, luminance(ill_p[..., :3]), phi_luma)
            weight = w * k
            sum_w = sum_w + weight
            sum_rgb = sum_rgb + ill_p[..., :3] * weight[..., None]
            sum_var = sum_var + ill_p[..., 3] * weight * weight

    out = jnp.concatenate(
        [sum_rgb / sum_w[..., None], (sum_var / (sum_w * sum_w))[..., None]],
        axis=-1)
    # background / far passthrough (atrous.comp:60-64)
    bg = (depth_c == 0.0) | (depth_c > 1000.0)
    return jnp.where(bg[..., None], signal, out)


def combine(filtered, albedo, use_albedo_remod: bool):
    """combine.comp: albedo re-modulation."""
    if not use_albedo_remod:
        return filtered
    return filtered.at[..., :3].set(filtered[..., :3] * albedo)


@dataclasses.dataclass(frozen=True)
class SVGFConfig:
    """SVGFPass::Config (SVGFPass.h:82-101) — static per-signal settings."""

    prefix: str = "SVGF"
    atrous_iterations: int = 3
    temporal_enabled: bool = True
    spatial_enabled: bool = True
    use_albedo_demod: bool = False
    # History-plane storage width: 32 (f32) or 16 (bf16 — the analog of
    # the reference's RGBA16F SVGF images, SVGFPass.cpp:24-164; halves
    # history HBM traffic, accumulation math stays f32)
    bits: int = 32


def denoise(cur_signal, albedo, gb_motion_plane, normal, object_id,
            history: SVGFSignalHistory, prev_normal, prev_lin_depth,
            prev_object_id, config: SVGFConfig, svgf_phi,
            history_valid: bool):
    """Full per-signal SVGF chain (SVGFPass::Add orchestration).

    Returns (denoised (H,W,4), new SVGFSignalHistory, variance_debug (H,W)).
    """
    (out,) = denoise_multi(
        [cur_signal], albedo, gb_motion_plane, normal, object_id,
        [history], prev_normal, prev_lin_depth, prev_object_id, [config],
        svgf_phi, history_valid)
    return out


def denoise_multi(cur_signals, albedo, gb_motion_plane, normal, object_id,
                  histories, prev_normal, prev_lin_depth, prev_object_id,
                  configs, svgf_phi, history_valid: bool):
    """Fused SVGF chains for K signals over ONE frame's geometry.

    The reference instantiates 3 independent chains (SVGFPass::Add ×3,
    HybridRenderPath.cpp:57-87); semantics here are identical per
    signal, but the temporal footprint bases and reprojection tests are
    computed once for all signals (temporal_multi).

    Returns [(denoised (H,W,4), new SVGFSignalHistory, variance (H,W))]×K.
    """
    K = len(cur_signals)
    signals = list(cur_signals)
    moments = [None] * K
    new_hist_signals = [h.signal for h in histories]
    new_hist_moments = [h.moments for h in histories]

    t_idx = [k for k in range(K) if configs[k].temporal_enabled]
    if t_idx:
        fetched = temporal_multi(
            [cur_signals[k] for k in t_idx], albedo, gb_motion_plane,
            normal, object_id, [histories[k] for k in t_idx],
            prev_normal, prev_lin_depth, prev_object_id,
            [configs[k].use_albedo_demod for k in t_idx], history_valid)
        for k, (sig, mom) in zip(t_idx, fetched):
            new_hist_moments[k] = mom
            sig, mom = filter_moments(
                sig, mom, normal, gb_motion_plane, svgf_phi)
            mom = variance_blur(mom)
            signals[k] = sig
            moments[k] = mom

    results = []
    for k in range(K):
        config = configs[k]
        signal, mom = signals[k], moments[k]
        if config.spatial_enabled:
            if mom is None:
                mom = jnp.zeros_like(cur_signals[k])
                signal = cur_signals[k]
            for i in range(config.atrous_iterations):
                signal = atrous(signal, mom, normal, gb_motion_plane,
                                1 << i, svgf_phi)
                if i == 0:
                    # SVGFPass.cpp:207-214 SaveAsHistory
                    new_hist_signals[k] = signal

        variance_debug = signal[..., 3]
        out = combine(signal, albedo, config.use_albedo_demod)
        # history planes persist in the config's storage width (bf16
        # when bits=16 — the reference's RGBA16F analog)
        store_dt = jnp.bfloat16 if config.bits == 16 else jnp.float32
        new_history = SVGFSignalHistory(
            signal=new_hist_signals[k].astype(store_dt),
            moments=new_hist_moments[k].astype(store_dt))
        results.append((out, new_history, variance_debug))
    return results
