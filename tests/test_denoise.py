"""SVGF + TAA unit tests (small images, property-based)."""
import jax.numpy as jnp
import numpy as np

from hybridrenderer.ops import svgf, taa

H, W = 24, 32
PHI = jnp.array([4.0, 128.0, 0.02, 0.0], jnp.float32)


def _flat_geom(depth_val=5.0):
    normal = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (H, W, 1))
    motion_plane = jnp.zeros((H, W, 4)).at[..., 2].set(depth_val)
    oid = jnp.zeros((H, W), jnp.int32)
    return normal, motion_plane, oid


def test_temporal_accumulates_history_length():
    normal, mp, oid = _flat_geom()
    hist = svgf.SVGFSignalHistory.create(H, W)
    sig = jnp.ones((H, W, 4))
    albedo = jnp.ones((H, W, 3))
    out, moments = svgf.temporal(sig, albedo, mp, normal, oid, hist,
                                 normal, mp[..., 2], oid,
                                 use_albedo_demod=False, history_valid=False)
    assert float(moments[..., 3].mean()) == 1.0
    hist2 = svgf.SVGFSignalHistory(signal=out, moments=moments)
    out2, moments2 = svgf.temporal(sig, albedo, mp, normal, oid, hist2,
                                   normal, mp[..., 2], oid,
                                   use_albedo_demod=False, history_valid=True)
    assert float(moments2[..., 3].mean()) == 2.0
    np.testing.assert_allclose(np.asarray(out2), np.asarray(sig), atol=1e-5)


def test_temporal_variance_decreases():
    """EMA over noisy constant-mean signal shrinks luma variance."""
    rng = np.random.default_rng(3)
    normal, mp, oid = _flat_geom()
    albedo = jnp.ones((H, W, 3))
    hist = svgf.SVGFSignalHistory.create(H, W)
    var0 = None
    for frame in range(12):
        noise = rng.random((H, W, 1)).astype(np.float32)
        sig = jnp.concatenate(
            [jnp.asarray(np.repeat(noise, 3, -1)), jnp.ones((H, W, 1))], -1)
        out, moments = svgf.temporal(
            sig, albedo, mp, normal, oid, hist, normal, mp[..., 2], oid,
            use_albedo_demod=False, history_valid=frame > 0)
        hist = svgf.SVGFSignalHistory(signal=out, moments=moments)
        if frame == 1:
            var0 = float(moments[..., 2].mean())
    var_end = float(moments[..., 2].mean())
    # accumulated signal's own variance across pixels also shrinks
    spatial_spread = float(np.var(np.asarray(out[..., 0])))
    assert spatial_spread < float(np.var(noise)) * 0.5


def test_temporal_rejects_id_mismatch():
    normal, mp, oid = _flat_geom()
    hist = svgf.SVGFSignalHistory(
        signal=jnp.full((H, W, 4), 100.0),
        moments=jnp.full((H, W, 4), 9.0))
    prev_oid = jnp.ones((H, W), jnp.int32)  # different object last frame
    sig = jnp.ones((H, W, 4)) * 0.5
    out, moments = svgf.temporal(sig, jnp.ones((H, W, 3)), mp, normal, oid,
                                 hist, normal, mp[..., 2], prev_oid,
                                 use_albedo_demod=False, history_valid=True)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-6)  # no ghosting
    assert float(moments[..., 3].mean()) == 1.0


def test_atrous_preserves_uniform_image():
    normal, mp, oid = _flat_geom()
    sig = jnp.full((H, W, 4), 0.7).at[..., 3].set(0.01)
    out = svgf.atrous(sig, sig, normal, mp, step=1, svgf_phi=PHI)
    np.testing.assert_allclose(np.asarray(out[..., :3]), 0.7, atol=1e-5)


def test_atrous_smooths_noise():
    rng = np.random.default_rng(0)
    normal, mp, oid = _flat_geom()
    noisy = rng.random((H, W)).astype(np.float32)
    sig = jnp.stack([noisy, noisy, noisy, np.full_like(noisy, 0.1)], -1)
    out = svgf.atrous(sig, sig, normal, mp, step=1, svgf_phi=PHI)
    assert np.var(np.asarray(out[..., 0])) < np.var(noisy) * 0.8


def test_filter_moments_boosts_young_variance():
    normal, mp, oid = _flat_geom()
    rng = np.random.default_rng(1)
    noisy = jnp.asarray(rng.random((H, W, 1)).astype(np.float32))
    sig = jnp.concatenate([jnp.repeat(noisy, 3, -1), jnp.zeros((H, W, 1))], -1)
    luma = noisy[..., 0]
    # m2 = m1 → per-pixel var m1 - m1² > 0 for 0 < m1 < 1
    young = jnp.stack([luma, luma, jnp.zeros_like(luma),
                       jnp.ones_like(luma)], -1)
    old = young.at[..., 3].set(10.0)
    _, m_young = svgf.filter_moments(sig, young, normal, mp, PHI)
    _, m_old = svgf.filter_moments(sig, old, normal, mp, PHI)
    assert float(m_young[..., 2].mean()) > float(m_old[..., 2].mean()) * 2.0


def test_variance_blur_spreads_spike():
    m = jnp.zeros((H, W, 4)).at[H // 2, W // 2, 2].set(1.0)
    out = svgf.variance_blur(m)
    assert float(out[H // 2, W // 2 + 1, 2]) > 0.2  # max-component smears
    assert float(out[H // 2, W // 2, 2]) > 0.5


def test_denoise_full_chain_runs():
    normal, mp, oid = _flat_geom()
    rng = np.random.default_rng(5)
    sig = jnp.asarray(rng.random((H, W, 4)).astype(np.float32))
    albedo = jnp.full((H, W, 3), 0.5)
    hist = svgf.SVGFSignalHistory.create(H, W)
    cfg = svgf.SVGFConfig(prefix="T", atrous_iterations=3,
                          use_albedo_demod=True)
    out, new_hist, var = svgf.denoise(
        sig, albedo, mp, normal, oid, hist, normal, mp[..., 2], oid, cfg,
        PHI, history_valid=False)
    assert out.shape == (H, W, 4)
    assert np.isfinite(np.asarray(out)).all()
    assert new_hist.signal.shape == (H, W, 4)
    # demod+remod roundtrip: uniform signal stays near its value
    assert 0.0 < float(out[..., :3].mean()) < 2.0


def test_denoise_bits16_close_to_f32():
    """bf16 history storage (reference RGBA16F analog): two-frame chain
    stays within bf16 rounding of the f32 chain; history persists bf16."""
    normal, mp, oid = _flat_geom()
    rng = np.random.default_rng(9)
    sigs = [jnp.asarray(rng.random((H, W, 4)).astype(np.float32))
            for _ in range(2)]
    albedo = jnp.full((H, W, 3), 0.5)

    def run(bits):
        cfg = svgf.SVGFConfig(prefix="T", atrous_iterations=2,
                              use_albedo_demod=True, bits=bits)
        hist = svgf.SVGFSignalHistory.create(H, W)
        out, hist, _ = svgf.denoise(sigs[0], albedo, mp, normal, oid,
                                    hist, normal, mp[..., 2], oid, cfg,
                                    PHI, history_valid=False)
        out, hist, _ = svgf.denoise(sigs[1], albedo, mp, normal, oid,
                                    hist, normal, mp[..., 2], oid, cfg,
                                    PHI, history_valid=True)
        return out, hist

    out32, _ = run(32)
    out16, hist16 = run(16)
    assert hist16.signal.dtype == jnp.bfloat16
    assert hist16.moments.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(out16)).all()
    # one bf16 quantization of the history EMA: ~2^-8 relative
    err = np.abs(np.asarray(out16) - np.asarray(out32))
    assert err.max() < 0.02, err.max()


# --- TAA -------------------------------------------------------------------

def _taa_inputs(color_val=0.5):
    cur = jnp.full((H, W, 3), color_val)
    motion = jnp.zeros((H, W, 2))
    depth = jnp.full((H, W), 0.5)
    j = jnp.zeros((2,))
    return cur, motion, depth, j


def test_taa_static_identity():
    cur, motion, depth, j = _taa_inputs()
    out = taa.resolve(cur, cur, motion, depth, j, j, history_valid=True)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-4)


def test_taa_disabled_passthrough():
    cur, motion, depth, j = _taa_inputs()
    hist = jnp.zeros_like(cur)
    out = taa.resolve(cur, hist, motion, depth, j, j, history_valid=True,
                      enabled=False)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(cur))


def test_taa_clips_stale_history():
    """History far outside the neighborhood AABB must be clipped toward
    the current color (ghosting kill)."""
    cur, motion, depth, j = _taa_inputs(0.2)
    hist = jnp.full((H, W, 3), 50.0)
    out = taa.resolve(cur, hist, motion, depth, j, j, history_valid=True)
    assert float(np.abs(np.asarray(out) - 0.2).max()) < 0.05


def test_taa_nan_history_safe():
    cur, motion, depth, j = _taa_inputs()
    hist = jnp.full((H, W, 3), jnp.nan)
    out = taa.resolve(cur, hist, motion, depth, j, j, history_valid=True)
    assert np.isfinite(np.asarray(out)).all()


def test_denoise_multi_matches_single():
    """The fused K-signal chain (denoise_multi / temporal_multi) is
    pixel-identical to K independent chains."""
    rng = np.random.default_rng(21)
    Ht, Wt = 64, 256
    normal = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (Ht, Wt, 1))
    mp = jnp.zeros((Ht, Wt, 4)).at[..., 2].set(5.0).at[..., :2].set(0.003)
    oid = jnp.zeros((Ht, Wt), jnp.int32)
    albedo = jnp.asarray(rng.random((Ht, Wt, 3)).astype(np.float32)) + 0.1

    sigs, hists, cfgs = [], [], []
    for k, demod in enumerate((False, True, True)):
        sigs.append(jnp.asarray(rng.random((Ht, Wt, 4)).astype(np.float32)))
        hists.append(svgf.SVGFSignalHistory(
            signal=jnp.asarray(rng.random((Ht, Wt, 4)).astype(np.float32)),
            moments=jnp.asarray(
                rng.random((Ht, Wt, 4)).astype(np.float32)) + 0.5))
        cfgs.append(svgf.SVGFConfig(prefix=f"S{k}", use_albedo_demod=demod))

    for cfgs_g in (cfgs,):
        multi = svgf.denoise_multi(
            sigs, albedo, mp, normal, oid, hists, normal, mp[..., 2], oid,
            cfgs_g, PHI, history_valid=True)
        for k in range(3):
            out_s, hist_s, var_s = svgf.denoise(
                sigs[k], albedo, mp, normal, oid, hists[k], normal,
                mp[..., 2], oid, cfgs_g[k], PHI, history_valid=True)
            out_m, hist_m, var_m = multi[k]
            np.testing.assert_array_equal(np.asarray(out_m),
                                          np.asarray(out_s))
            np.testing.assert_array_equal(np.asarray(hist_m.signal),
                                          np.asarray(hist_s.signal))
            np.testing.assert_array_equal(np.asarray(hist_m.moments),
                                          np.asarray(hist_s.moments))
            np.testing.assert_array_equal(np.asarray(var_m),
                                          np.asarray(var_s))
