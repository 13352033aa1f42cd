"""Golden-image ladder: hybrid paths, cut-out
alpha, display modes, and a textured .glb scene — the image-regression
substitute for the reference's 12 eyeball display modes (SURVEY §4,
composition.frag:78-93).

Tolerance rationale: renders are deterministic on one backend; goldens
are generated on the CPU backend (tests/conftest.py forces it), so drift
only comes from XLA codegen changes across versions. u8 tolerance p99<=2
/ max<=16 matches test_golden.py: catches structural regressions while
tolerating float reassociation.

Regenerate after an INTENDED change (from the repo root):
  python -m tests.test_golden_ladder regen
then eyeball the PNGs in tests/goldens/ before committing. Regen forces
the CPU backend itself (goldens are CPU-generated; conftest does the
same for test runs).
"""
import os
import sys

if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import DisplayMode, RenderFlags, \
    RenderPathType
from hybridrenderer.runtime.output import read_png, to_u8, write_png
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _render(case):
    data = case["scene"]().build()
    # goldens pin the sampling block size: the ao_block/gi_block DEFAULT
    # is a perf tunable and 2-frame goldens are far
    # from SVGF convergence, so re-tuning it must not move the images
    s = RenderSettings(width=case.get("size", 128),
                       height=case.get("size", 128),
                       path=case["path"], flags=case["flags"],
                       display_mode=case.get("display", DisplayMode.FINAL),
                       ao_block=8, gi_block=8)
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=s.width, height=s.height, **case["cam"])
    img = None
    for _ in range(case.get("frames", 1)):
        img = r.render_np(cam.step(taa_enabled=bool(
            case["flags"] & RenderFlags.TAA)))
    return to_u8(img)


CUBE_CAM = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))
CORNELL_CAM = dict(distance=13.0, pitch=0.0, yaw=0.0,
                   focal_point=(0, 2.5, 0))
HY = RenderFlags.default_hybrid()

CASES = {
    # hybrid path: raster G-buffer + RT shadow/AO + SVGF + composition
    "cube_hybrid_128": dict(scene=scenes.cube_scene,
                            path=RenderPathType.HYBRID, flags=HY,
                            cam=CUBE_CAM, frames=2),
    # cornell: NEE area light + GI + reflections (full graph)
    "cornell_full_128": dict(
        scene=scenes.cornell_scene, path=RenderPathType.HYBRID,
        flags=HY | RenderFlags.REFLECTION | RenderFlags.GI,
        cam=CORNELL_CAM, frames=2),
    # cut-out alpha: gbuffer discard + transparent any-hit skip
    "cutout_hybrid_128": dict(
        scene=scenes.cutout_scene, path=RenderPathType.HYBRID, flags=HY,
        cam=dict(distance=9.0, pitch=0.35, yaw=0.4,
                 focal_point=(0, 1.2, 0)), frames=2),
    # display modes (composition.frag:78-93 debug views)
    "cube_display_normal_128": dict(
        scene=scenes.cube_scene, path=RenderPathType.HYBRID, flags=HY,
        cam=CUBE_CAM, display=DisplayMode.NORMAL),
    "cube_display_depth_128": dict(
        scene=scenes.cube_scene, path=RenderPathType.HYBRID, flags=HY,
        cam=CUBE_CAM, display=DisplayMode.DEPTH),
    "cube_display_shadow_128": dict(
        scene=scenes.cube_scene, path=RenderPathType.HYBRID, flags=HY,
        cam=CUBE_CAM, display=DisplayMode.SHADOW, frames=2),
    # ray-traced path (primary rays + TAA)
    "cube_raytraced_128": dict(
        scene=scenes.cube_scene, path=RenderPathType.RAYTRACED,
        flags=RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA
        | RenderFlags.EMISSIVE, cam=CUBE_CAM, frames=2),
    # the flagship config in miniature: textured
    # stress geometry through the hybrid path — all four texture slots
    # bound, slot-gated sampling + quad-texel layout on the same image
    "stress_textured_128": dict(
        scene=lambda: scenes.stress_scene(num_objects=24, textured=True),
        path=RenderPathType.HYBRID, flags=HY,
        cam=dict(distance=18.0, pitch=0.5, yaw=0.8,
                 focal_point=(0, 2.0, 0)), frames=2),
}


def _check(name):
    img = _render(CASES[name])
    golden = read_png(os.path.join(GOLDEN_DIR, name + ".png"))
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert np.percentile(diff, 99) <= 2, \
        f"{name}: p99 diff {np.percentile(diff, 99)}"
    assert diff.max() <= 16, f"{name}: max diff {diff.max()}"


def test_cube_hybrid_golden():
    _check("cube_hybrid_128")


def test_cornell_full_graph_golden():
    _check("cornell_full_128")


def test_cutout_alpha_golden():
    _check("cutout_hybrid_128")


def test_display_mode_goldens():
    _check("cube_display_normal_128")
    _check("cube_display_depth_128")
    _check("cube_display_shadow_128")


def test_raytraced_golden():
    _check("cube_raytraced_128")


def test_stress_textured_golden():
    _check("stress_textured_128")


def test_textured_gltf_golden():
    """Textured .glb through the self-contained loader (AssetImporter
    analog) — exercises the texture atlas sampler in a full frame."""
    from hybridrenderer.scene.loader import load_scene_file
    glb = os.path.join(GOLDEN_DIR, "textured_tri.glb")
    sc = load_scene_file(glb)
    data = sc.build()
    s = RenderSettings(width=96, height=96, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL)
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=96, height=96, distance=4.0, pitch=0.3, yaw=0.2)
    img = to_u8(r.render_np(cam.step()))
    golden = read_png(os.path.join(GOLDEN_DIR, "textured_gltf_96.png"))
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert np.percentile(diff, 99) <= 2
    assert diff.max() <= 16


if __name__ == "__main__" and "regen" in sys.argv:
    for name, case in CASES.items():
        img = _render(case)
        write_png(os.path.join(GOLDEN_DIR, name + ".png"), img)
        print("wrote", name, img.mean().round(1))
