"""ctypes bridge to the native OBJ parser (native/obj_loader.cpp).

The reference keeps its asset import native (Assimp). Here the tokenizer
lives in C++ (built on first use by hybridrenderer/native.py) and
Python keeps the material/scene assembly. Falls back to the pure-Python
parser when no C++ compiler is available.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np



class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("texcoords", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("tri_indices", ctypes.POINTER(ctypes.c_int)),
        ("tri_material", ctypes.POINTER(ctypes.c_int)),
        ("material_names", ctypes.c_char_p),
        ("mtllib", ctypes.c_char_p),
        ("n_positions", ctypes.c_longlong),
        ("n_texcoords", ctypes.c_longlong),
        ("n_normals", ctypes.c_longlong),
        ("n_triangles", ctypes.c_longlong),
    ]


def _load() -> Optional[ctypes.CDLL]:
    from .. import native

    lib = native.load("loader")
    if lib is not None:
        lib.parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjResult)]
        lib.parse_obj.restype = ctypes.c_int
        lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
    return lib


def available() -> bool:
    return _load() is not None


def parse_obj_native(path: str):
    """Returns (positions (P,3), texcoords (T,2), normals (N,3),
    tri_indices (F,3,3) int32 v/vt/vn (-1 absent), tri_material (F,),
    material_names [str], mtllib str) — or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    res = _ObjResult()
    rc = lib.parse_obj(path.encode(), ctypes.byref(res))
    if rc != 0:
        return None
    try:
        def arr(ptr, n, w, dt):
            if n == 0:
                return np.zeros((0, w), dt)
            flat = np.ctypeslib.as_array(ptr, shape=(int(n) * w,))
            return flat.astype(dt, copy=True).reshape(int(n), w)

        positions = arr(res.positions, res.n_positions, 3, np.float32)
        texcoords = arr(res.texcoords, res.n_texcoords, 2, np.float32)
        normals = arr(res.normals, res.n_normals, 3, np.float32)
        tri = arr(res.tri_indices, res.n_triangles * 3, 3, np.int32)
        tri = tri.reshape(int(res.n_triangles), 3, 3)
        tri_mat = arr(res.tri_material, res.n_triangles, 1, np.int32)[:, 0]
        names = (res.material_names or b"").decode()
        mat_names = names.split("\n") if names else []
        mtllib = (res.mtllib or b"").decode()
        return positions, texcoords, normals, tri, tri_mat, mat_names, mtllib
    finally:
        lib.obj_free(ctypes.byref(res))
