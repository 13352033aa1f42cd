"""OBJ / glTF / PNG loader tests using generated fixtures."""
import base64
import json
import os
import struct

import numpy as np
import pytest

from hybridrenderer.runtime import output
from hybridrenderer.scene import loader, loader_obj


def test_png_roundtrip(tmp_path):
    img = (np.random.default_rng(0).random((17, 23, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "t.png")
    output.write_png(p, img)
    back = output.read_png(p)
    np.testing.assert_array_equal(back, img)


def test_obj_load(tmp_path):
    obj = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
"""
    mtl = """
newmtl red
Kd 0.8 0.1 0.1
Ns 250
d 1.0
"""
    (tmp_path / "test.obj").write_text(obj)
    (tmp_path / "test.mtl").write_text(mtl)
    meshes, materials, tex = loader_obj.load_obj(str(tmp_path / "test.obj"))
    assert len(meshes) == 1 and len(materials) == 1
    m = meshes[0]
    assert m.num_vertices == 4
    assert m.num_triangles == 2  # quad fan-triangulated
    np.testing.assert_allclose(materials[0].colour, (0.8, 0.1, 0.1))
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4)


def test_obj_negative_indices(tmp_path):
    obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
    (tmp_path / "n.obj").write_text(obj)
    meshes, _, _ = loader_obj.load_obj(str(tmp_path / "n.obj"))
    assert meshes[0].num_triangles == 1
    # no normals in file → generated
    np.testing.assert_allclose(np.linalg.norm(meshes[0].normals, axis=-1), 1.0,
                               atol=1e-5)


def _minimal_gltf(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    bin_data = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [2.0, 0.0, 0.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{"name": "m", "pbrMetallicRoughness": {
            "baseColorFactor": [0.2, 0.4, 0.6, 1.0],
            "roughnessFactor": 0.7, "metallicFactor": 0.1}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(bin_data),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(bin_data).decode()}],
    }
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(gltf))
    return str(p)


def test_gltf_load(tmp_path):
    path = _minimal_gltf(tmp_path)
    pairs, materials, tex = loader.load_scene_file(path), None, None
    sc = pairs
    assert len(sc.meshes) == 1
    assert len(sc.entities) == 1
    np.testing.assert_allclose(sc.materials[0].colour, (0.2, 0.4, 0.6))
    assert sc.materials[0].roughness == 0.7
    # node translation applied as entity transform
    np.testing.assert_allclose(sc.entities[0].transform[:3, 3], [2, 0, 0])
    data = sc.build()
    assert data.num_triangles == 1
    # world-space soup reflects the +2x translation
    assert float(data.triangles.v0[0][0]) >= 2.0


def test_glb_load(tmp_path):
    # wrap the gltf JSON + bin into a GLB container
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 0], np.uint16)  # padded to 4-byte align
    bin_chunk = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}], "scene": 0,
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    jchunk = json.dumps(gltf).encode()
    jchunk += b" " * ((4 - len(jchunk) % 4) % 4)
    total = 12 + 8 + len(jchunk) + 8 + len(bin_chunk)
    glb = (struct.pack("<III", 0x46546C67, 2, total)
           + struct.pack("<II", len(jchunk), 0x4E4F534A) + jchunk
           + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    p = tmp_path / "tri.glb"
    p.write_bytes(glb)
    sc = loader.load_scene_file(str(p))
    assert sc.build().num_triangles == 1


def test_texture_stack_build(tmp_path):
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 0] = 255
    img[..., 3] = 255
    p = str(tmp_path / "red.png")
    output.write_png(p, img)
    from hybridrenderer.scene.schema import Material

    mats = [Material(name="m")]
    stack = loader.build_texture_stack({0: {"colour": p}}, mats, max_size=16)
    assert stack is not None
    assert mats[0].colour_texture == 0
    assert tuple(np.asarray(stack.sizes[0])) == (8, 8)
    # sRGB→linear applied: 255 red stays 1.0
    np.testing.assert_allclose(np.asarray(stack.data[0, 0, 0]),
                               [1.0, 0.0, 0.0, 1.0], atol=1e-3)


def test_texture_stack_env_cap(tmp_path, monkeypatch):
    """HR_TEX_MAX sets the stack resolution (reference samples full-res
    textures; the 512 default is a memory cap, not a hard limit)."""
    img = np.zeros((32, 32, 4), np.uint8)
    img[..., 1] = 255
    img[..., 3] = 255
    p = str(tmp_path / "g.png")
    output.write_png(p, img)
    from hybridrenderer.scene.schema import Material

    monkeypatch.setenv("HR_TEX_MAX", "8")
    stack = loader.build_texture_stack({0: {"colour": p}},
                                       [Material(name="m")])
    assert stack.data.shape[1:3] == (8, 8)
    assert tuple(np.asarray(stack.sizes[0])) == (8, 8)


def test_native_matches_python(tmp_path, monkeypatch):
    """Native C++ parser and pure-Python parser produce the same mesh."""
    from hybridrenderer.scene import loader_native

    if not loader_native.available():
        pytest.skip("native loader unavailable")
    rng = np.random.default_rng(0)
    verts = rng.random((60, 3))
    lines = ["mtllib none.mtl"]
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    lines.append("usemtl matA")
    for i in range(0, 57, 3):
        lines.append(f"f {i+1} {i+2} {i+3}")
    p = tmp_path / "big.obj"
    p.write_text("\n".join(lines))

    native_meshes, _, _ = loader_obj.load_obj(str(p))
    monkeypatch.setattr(loader_native, "available", lambda: False)
    py_meshes, _, _ = loader_obj.load_obj(str(p))

    assert len(native_meshes) == len(py_meshes) == 1
    a, b = native_meshes[0], py_meshes[0]
    assert a.num_triangles == b.num_triangles
    # same triangle soup (order may differ): compare sorted centroid sets
    ca = np.sort(a.positions[a.indices.reshape(-1, 3)].mean(1), axis=0)
    cb = np.sort(b.positions[b.indices.reshape(-1, 3)].mean(1), axis=0)
    np.testing.assert_allclose(ca, cb, atol=1e-6)


def test_async_load_with_inflight_rendering(tmp_path):
    """LoadModelAsync analog (ResourceManager.cpp:440-475): rendering
    continues on the current scene while a loader future is in flight;
    the loaded scene swaps in when done."""
    import numpy as np

    from hybridrenderer.core.camera import OrbitCamera
    from hybridrenderer.core.config import RenderSettings
    from hybridrenderer.core.types import RenderFlags, RenderPathType
    from hybridrenderer.runtime.renderer import Renderer
    from hybridrenderer.scene import scene as scenes
    from hybridrenderer.scene.loader import load_scene_async

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")

    future = load_scene_async(str(obj))

    data = scenes.cube_scene().build()
    s = RenderSettings(width=48, height=48, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT)
    r = Renderer.for_scene(s, data)
    cam = OrbitCamera(width=48, height=48, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    frames = []
    while not future.done():
        frames.append(r.render_np(cam.step()))   # in-flight rendering
        if len(frames) > 200:
            break
    loaded = future.result(timeout=60)
    assert np.isfinite(frames[0]).all() if frames else True

    new_data = loaded.build()
    r2 = Renderer.for_scene(s, new_data)         # scene swap
    img = r2.render_np(cam.step())
    assert np.isfinite(img).all()
    assert new_data.num_triangles == 1


def test_tex_max_default_is_native_comparable():
    """The default texture cap is 1024 — fidelity-comparable with the
    reference's native-resolution bindless sampling (no silent 512).
    HR_TEX_MAX remains the capacity knob."""
    import os

    assert "HR_TEX_MAX" not in os.environ
    import inspect

    from hybridrenderer.scene import loader

    src = inspect.getsource(loader.build_texture_stack)
    assert '"1024"' in src
