"""Quantized narrow shade rows (schema.build_shade_rows_q) — the
Sponza-scale shade fetch.

Above the ~16 MB fast-gather byte gate the exact u16 shade table can't
ride the fast path; the quantized 29-col table (bf16 local
normals/tangents, exact uv base + f16 deltas, per-instance side table)
must stay within quantization tolerance of the exact fetch."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import schema
from hybridrenderer.scene import scene as scenes


def _with_q_table(data):
    """Force the quantized path on a small scene: drop the exact table,
    attach the q table (as a huge scene would get at build)."""
    q = schema.build_shade_rows_q(data.vertices, data.instances,
                                  data.triangles)
    ishade = schema.build_inst_shade(data.instances, data.materials)
    assert q is not None and q.shape[1] == schema.SHQ_WIDTH
    return dataclasses.replace(data, shade_rows=None, shade_rows_q=q,
                               inst_shade=ishade)


def test_decode_matches_exact_within_quantization():
    data = scenes.cornell_scene().build()
    dq = _with_q_table(data)
    T = int(data.triangles.i0.shape[0])
    rows = jnp.arange(T, dtype=jnp.int32)
    dec = np.asarray(schema.decode_shade_rows_q(
        dq.shade_rows_q[rows],
        dq.inst_shade[data.triangles.instance[rows]]))
    exact = np.asarray(schema.decode_shade_rows(
        schema.encode_shade_rows(data.attr_rows)[rows]))
    # per-vertex normals/tangents: bf16 relative error
    for k in range(3):
        base = 9 * k
        for lo, hi in ((0, 3), (3, 6)):
            a, e = dec[:, base + lo:base + hi], exact[:, base + lo:base + hi]
            np.testing.assert_allclose(a, e, rtol=1 / 128, atol=1e-3)
        # tangent w sign: exact
        np.testing.assert_array_equal(dec[:, base + 6], exact[:, base + 6])
        # uv: vertex 0 exact, others within f16-delta error
        if k == 0:
            np.testing.assert_array_equal(dec[:, 7:9], exact[:, 7:9])
        else:
            d_exact = exact[:, base + 7:base + 9] - exact[:, 7:9]
            tol = np.abs(d_exact) * 2e-3 + 1e-6
            assert (np.abs(dec[:, base + 7:base + 9]
                           - exact[:, base + 7:base + 9]) <= tol).all()
    # instance block: exact
    np.testing.assert_array_equal(dec[:, 27:], exact[:, 27:])


def test_q_path_frame_within_tolerance():
    """Full-graph frame through the q fetch vs the exact fetch — the
    bf16 attribute error must stay visually negligible (secondary-ray
    shading only; primary attributes ride the exact raster path)."""
    data = scenes.cornell_scene().build()
    dq = _with_q_table(data)
    s = RenderSettings(
        width=96, height=96, path=RenderPathType.HYBRID,
        flags=RenderFlags.default_hybrid() | RenderFlags.REFLECTION
        | RenderFlags.GI, ao_block=8, gi_block=8)
    cam = OrbitCamera(width=96, height=96, distance=13.0, pitch=0.0,
                      yaw=0.0, focal_point=(0, 2.5, 0))
    state = cam.step(taa_enabled=True)
    img_exact = np.asarray(Renderer.for_scene(s, data).render_np(state))
    img_q = np.asarray(Renderer.for_scene(s, dq).render_np(state))
    d = np.abs(img_exact - img_q)
    assert d.mean() < 2e-3, f"mean err {d.mean()}"
    assert np.percentile(d, 99) < 0.02, f"p99 {np.percentile(d, 99)}"


def test_build_declines_oversize_and_many_instances():
    data = scenes.cube_scene().build()
    soup = data.triangles
    # rows over the byte gate → None
    old = schema.SHADE_Q_ROWS_MAX
    try:
        schema.SHADE_Q_ROWS_MAX = int(soup.i0.shape[0]) - 1
        assert schema.build_shade_rows_q(
            data.vertices, data.instances, soup) is None
    finally:
        schema.SHADE_Q_ROWS_MAX = old
