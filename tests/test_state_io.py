"""Checkpoint/resume of the carried FrameState."""
import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.runtime import state_io
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes


def test_checkpoint_resume_bitexact(tmp_path):
    data = scenes.cube_scene().build()
    s = RenderSettings(width=48, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.TAA,
                       raster_backend="jnp")

    def run(n, resume_from=None):
        r = Renderer(s, data)
        cam = OrbitCamera(width=48, height=64, distance=7.0, pitch=0.45,
                          yaw=0.6, focal_point=(0, 0.7, 0))
        if resume_from:
            state_io.restore_renderer(resume_from, r)
            for _ in range(r.frame_count):
                cam.step(True)  # fast-forward camera to the same phase
        outs = []
        for _ in range(n):
            outs.append(r.render_np(cam.step(True)))
        return r, outs

    # straight 4-frame run
    _, ref = run(4)
    # 2 frames, checkpoint, resume, 2 more
    r, _ = run(2)
    ck = str(tmp_path / "state.npz")
    state_io.save_renderer(ck, r)
    _, resumed = run(2, resume_from=ck)
    np.testing.assert_allclose(resumed[0], ref[2], atol=1e-6)
    np.testing.assert_allclose(resumed[1], ref[3], atol=1e-6)
