"""Top-level scene file loading + texture stacking + async import.

Mirrors the reference's asset pipeline (SURVEY §3.4): AssetImporter parse
→ parallel texture decode on a thread pool (TaskSystem analog;
AssetImporter.cpp:160-200 dedupes and decodes textures concurrently) →
scene assembly. ``load_scene_file`` is synchronous;
``load_scene_async`` returns a Future (ResourceManager::LoadModelAsync /
UpdateLoadingTasks analog).

Textures are decoded to linear float RGBA and padded into one
(N, S, S, 4) TextureStack (ResourceManager's 1024-texture bindless array
analog); color textures are sRGB→linear converted, data textures
(normal/roughness) stay linear — matching Vulkan's _SRGB vs _UNORM
format split.
"""
from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from ..core.types import INVALID_ID
from .scene import Scene
from .schema import TextureStack

_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """Shared worker pool (TaskSystem: hardware_concurrency-1 workers,
    TaskSystem.cpp:7-20)."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) - 1))
    return _POOL


def decode_image(path: str, srgb: bool) -> np.ndarray:
    """Decode to float32 linear RGBA (stb_image analog)."""
    try:
        from PIL import Image

        img = Image.open(path).convert("RGBA")
        arr = np.asarray(img, np.float32) / 255.0
    except Exception:
        from ..runtime.output import read_png

        raw = read_png(path)
        if raw.shape[-1] == 3:
            raw = np.concatenate(
                [raw, np.full(raw.shape[:2] + (1,), 255, np.uint8)], -1)
        arr = raw.astype(np.float32) / 255.0
    if srgb:
        rgb = arr[..., :3]
        arr = np.concatenate([np.power(rgb, 2.2), arr[..., 3:]], -1)
    return arr


def _resize(img, out_h: int, out_w: int):
    """Bilinear resize of (H, W, C) pixels (pixel-center sampling, edge
    clamp) in numpy, quantized to 8 bits like the decoded texels."""
    h, w = img.shape[:2]

    def axis(n_in, n_out):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1)
        i0 = np.floor(x).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (x - i0).astype(np.float32)

    y0, y1, fy = axis(h, out_h)
    x0, x1, fx = axis(w, out_w)
    fx = fx[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    out = top * (1 - fy[:, None, None]) + bot * fy[:, None, None]
    return np.round(np.clip(out, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0


def build_texture_stack(tex_paths: Dict[int, Dict[str, str]], materials,
                        max_size: int = None) -> Optional[TextureStack]:
    """Decode all referenced textures concurrently, dedupe by path, stack
    padded, and patch material texture indices in place.

    ``max_size``: per-texture resolution cap (None → env HR_TEX_MAX →
    1024 — the fidelity-comparable default vs the reference's native-
    resolution bindless array, ResourceManager.cpp:253,651-689). Every
    texture shares one padded (n, S, S, 4) stack and the quad-texel
    layout (schema.build_quads) costs 4x again, so device memory for the
    stack is n * S^2 * 64 B — S=1024 / 50 textures = 3.4 GB (the schema
    memory budget gate falls back to 4-tap sampling and u8 storage above
    budget). Set HR_TEX_MAX=512 to trade fidelity for memory and
    sampling cost."""
    if max_size is None:
        max_size = int(os.environ.get("HR_TEX_MAX", "1024"))
    unique: Dict[str, int] = {}
    jobs = []
    slot_srgb = {"colour": True, "emission": True, "roughness": False,
                 "normal": False}
    for mat_idx, slots in tex_paths.items():
        for slot, path in slots.items():
            if path.startswith("__embedded__"):
                continue
            if path not in unique and os.path.exists(path):
                unique[path] = len(unique)
                jobs.append((path, slot_srgb.get(slot, False)))
    if not unique:
        return None

    def job(args):
        path, srgb = args
        img = decode_image(path, srgb)
        h, w = img.shape[:2]
        scale = max(h, w) / max_size
        if scale > 1.0:
            img = _resize(img, max(1, int(h / scale)), max(1, int(w / scale)))
        return img

    decoded = list(_pool().map(job, jobs))
    S = max_size
    n = len(decoded)
    stack = np.zeros((n, S, S, 4), np.float32)
    sizes = np.ones((n, 2), np.int32)
    for i, img in enumerate(decoded):
        h, w = img.shape[:2]
        h, w = min(h, S), min(w, S)
        stack[i, :h, :w] = img[:h, :w]
        sizes[i] = (h, w)

    for mat_idx, slots in tex_paths.items():
        m = materials[mat_idx]
        for slot, path in slots.items():
            ti = unique.get(path, INVALID_ID)
            if slot == "colour":
                m.colour_texture = ti
            elif slot == "emission":
                m.emission_texture = ti
            elif slot == "roughness":
                m.roughness_texture = ti
            elif slot == "normal":
                m.normal_texture = ti
    return TextureStack(data=jnp.asarray(stack), sizes=jnp.asarray(sizes))


def load_scene_file(path: str, max_texture_size: int = None) -> Scene:
    """OBJ / glTF / GLB → host Scene (call .build() for device data)."""
    ext = os.path.splitext(path)[1].lower()
    sc = Scene(name=os.path.basename(path))
    if ext == ".obj":
        from .loader_obj import load_obj

        meshes, materials, tex_paths = load_obj(path)
        sc.materials = materials
        for m in meshes:
            sc.add_entity(sc.add_mesh(m), name=m.name)
    elif ext in (".gltf", ".glb"):
        from .loader_gltf import load_gltf

        pairs, materials, tex_paths = load_gltf(path)
        sc.materials = materials
        for mesh, world in pairs:
            sc.add_entity(sc.add_mesh(mesh), world, name=mesh.name)
    else:
        raise ValueError(f"unsupported scene format: {ext}")
    sc.textures = build_texture_stack(tex_paths, sc.materials,
                                      max_texture_size)
    return sc


def load_scene_async(path: str, **kw) -> "Future[Scene]":
    """Async import (LoadModelAsync analog): parse + decode off-thread;
    poll ``future.done()`` from the frame loop like UpdateLoadingTasks."""
    return _pool().submit(load_scene_file, path, **kw)


def load_hdr_equirect(path: str) -> np.ndarray:
    """Radiance .hdr loader for skyboxes (LoadHDRTexture analog,
    ResourceManager.cpp:691-728). Returns float32 (H, W, 4)."""
    with open(path, "rb") as f:
        data = f.read()
    # minimal RGBE parser
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad HDR header")
    header, body = data[:pos].decode("latin1"), data[pos + 2:]
    nl = body.find(b"\n")
    dims = body[:nl].decode("latin1").split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.zeros((h, w, 4), np.uint8)
    p = nl + 1
    for y in range(h):
        if body[p:p + 2] == b"\x02\x02":  # RLE scanline
            p += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = body[p]; p += 1
                    if count > 128:
                        row[c, x:x + count - 128] = body[p]; p += 1
                        x += count - 128
                    else:
                        row[c, x:x + count] = np.frombuffer(
                            body[p:p + count], np.uint8)
                        p += count
                        x += count
            rgbe[y] = row.T
        else:  # flat
            row = np.frombuffer(body[p:p + w * 4], np.uint8).reshape(w, 4)
            rgbe[y] = row
            p += w * 4
    exp = rgbe[..., 3].astype(np.int32) - 136
    scale = np.ldexp(1.0, exp).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return np.concatenate([rgb, np.ones((h, w, 1), np.float32)], -1)
