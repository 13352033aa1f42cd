"""Runtime features: live path switching + frame stats (EditorLayer
analog, EditorLayer.cpp:182-540 / Application.cpp:408-448)."""
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes


def test_live_path_switch_and_frame_stats():
    data = scenes.cube_scene().build()
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.default_hybrid())
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    fwd = r.render_np(cam.step())
    assert r.frame_count == 1

    r.switch_path(RenderPathType.HYBRID)
    assert r.frame_count == 0          # history dropped (RenderPath.cpp:50-56)
    hyb = r.render_np(cam.step())
    assert np.isfinite(hyb).all()
    assert np.abs(hyb - fwd).mean() > 1e-4   # different pipeline output

    stats = r.frame_stats()
    assert stats["instances_drawn"] >= 1
    assert stats["instances_drawn"] + stats["instances_culled"] == \
        int(data.instances.count)

    # switch back: forward still works (fresh fn cache)
    r.switch_path(RenderPathType.FORWARD)
    fwd2 = r.render_np(cam.step())
    np.testing.assert_allclose(fwd2, fwd, atol=1e-5)


def test_switch_path_builds_tracer_on_demand():
    data = scenes.cube_scene().build()
    s = RenderSettings(width=48, height=48, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.SHADOW)
    r = Renderer(s, data)          # constructed WITHOUT a tracer
    assert r.tracer is None
    r.switch_path(RenderPathType.HYBRID)
    assert r.tracer is not None    # auto-attached for the RT passes
    img = r.render_np(OrbitCamera(width=48, height=48, distance=7.0,
                                  pitch=0.45).step())
    assert np.isfinite(img).all()


def test_structured_log_channels(capsys):
    """Log component analog (Log.h:10-30): named channels, levels,
    structured fields, caller location."""
    import logging

    from hybridrenderer.runtime import log

    ch = log.core().bind(scene="cube")
    rec = {}

    class Capture(logging.Handler):
        def emit(self, record):
            rec["line"] = self.format(record)

    lg = logging.getLogger("CHIMERA")
    cap = Capture()
    cap.setFormatter(lg.handlers[0].formatter)
    lg.addHandler(cap)
    try:
        ch.info("scene built", tris=12)
        assert "CHIMERA info" in rec["line"]
        assert "scene=cube" in rec["line"] and "tris=12" in rec["line"]
        assert "test_runtime.py" in rec["line"]   # caller, not log.py
        ch.trace("suppressed at info")            # default level: info
        assert "suppressed" not in rec["line"]
    finally:
        lg.removeHandler(cap)


def test_burst_matches_sequential_renders():
    """render_burst (frames-in-flight analog): K frames in one dispatch
    must be bit-identical to K sequential render() calls, history
    included."""
    from hybridrenderer.core.types import RenderFlags as RF

    data = scenes.cornell_scene().build()
    # forward + TAA: cheap to compile on CPU, still carries history
    # through the scan (the hybrid/SVGF burst is exercised on the GPU
    # via bench.py BENCH_BURST)
    s = RenderSettings(width=48, height=48, path=RenderPathType.FORWARD,
                       flags=RF.LIGHT | RF.TAA)

    def cams(n):
        cam = OrbitCamera(width=48, height=48, distance=6.0, pitch=0.3,
                          yaw=0.4, focal_point=(0, 1.0, 0))
        out = []
        for _ in range(n):
            out.append(cam.step(taa_enabled=True))
            cam.orbit(0.02, 0.0)
        return out

    seq = Renderer.for_scene(s, data)
    frames_seq = [seq.render_np(c) for c in cams(3)]
    bur = Renderer.for_scene(s, data)
    frames_bur = np.asarray(bur.render_burst(cams(3)))
    assert frames_bur.shape[0] == 3
    for i in range(3):
        np.testing.assert_array_equal(frames_bur[i], frames_seq[i])
