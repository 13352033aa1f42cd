"""CUDA ray traversal (ops/cuda/traverse.cu) called through ``jax.ffi``.

One thread per ray walks the binary SAH tree that ``intersect_bvh``
walks, from a node buffer that stores both children's boxes per node
(``pack_nodes``). The result contract is ``intersect_bvh``'s: (t, tri,
u, v), tri = -1 and t = +inf on a miss; inactive rays miss.

The shared library is built from the ``.cu`` source into
``<checkout>/build/cuda/`` on first use (or ahead of time with
``python -m hybridrenderer.ops.trace_cuda``). Its file name carries
a hash of the source and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded. A failed ``nvcc`` raises.

``walk_packed`` is the plain numpy walker over the same buffers — the
reference the CPU tests hold the layout and the kernel's logic to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "cuda", "traverse.cu")
_BUILD_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "build", "cuda"))
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")
# --fmad=false: no multiply-add contraction, so every product and sum
# rounds as in the jnp reference (ops/trace.ray_triangle / ray_aabb)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
TARGETS = {False: "hr_traverse_closest", True: "hr_traverse_any"}
_SYMBOLS = {False: "HrTraverseClosest", True: "HrTraverseAny"}
_registered = False
_lock = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libhr_traverse_{digest.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile traverse.cu unless the library for this source exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [NVCC, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {NVCC}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: concurrent builders never load halves
    return path


def _register():
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        for any_hit, target in TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[any_hit])),
                platform="CUDA")
        _registered = True


def root_ref(num_tris: int):
    """Reference the walk starts from: internal node 0, the single leaf
    ~0 of a one-triangle tree, or None for an empty scene."""
    if num_tris == 0:
        return None
    return 0 if num_tris > 1 else ~0


def pack_nodes(bvh, v0, v1, v2):
    """BVH → (nodes (max(T-1,1), 16) f32, tris (max(T,1), 12) f32).

    Internal node i holds [left box, right box, left ref, right ref]; a
    child ref >= 0 is an internal node, ~k a leaf slot k whose record is
    [v0, v1, v2, original tri id]. jnp, so a refit repacks on device."""
    T = v0.shape[0]
    if T == 0:
        return (jnp.zeros((1, 16), jnp.float32),
                jnp.zeros((1, 12), jnp.float32))
    n_int = T - 1

    def bits(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)

    leaf_tri = bvh.tri[n_int:]
    tris = jnp.concatenate(
        [v0[leaf_tri], v1[leaf_tri], v2[leaf_tri], bits(leaf_tri)[:, None],
         jnp.zeros((T, 2), jnp.float32)], axis=1)
    if n_int == 0:
        return jnp.zeros((1, 16), jnp.float32), tris
    left, right = bvh.left[:n_int], bvh.right[:n_int]

    def ref(c):
        return jnp.where(c >= n_int, ~(c - n_int), c)

    nodes = jnp.concatenate(
        [bvh.node_min[left], bvh.node_max[left], bvh.node_min[right],
         bvh.node_max[right], bits(ref(left))[:, None],
         bits(ref(right))[:, None], jnp.zeros((n_int, 2), jnp.float32)],
        axis=1)
    return nodes, tris


def intersect(nodes, tris, root, o, d, tmin, tmax, any_hit: bool,
              active=None):
    """Trace flat rays (R, 3) with the CUDA kernel → (t, tri, u, v)."""
    R = o.shape[0]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (R,))
    if root is None or R == 0:
        return (jnp.full((R,), jnp.inf, jnp.float32),
                jnp.full((R,), -1, jnp.int32),
                jnp.zeros((R,), jnp.float32), jnp.zeros((R,), jnp.float32))
    active = jnp.ones((R,), bool) if active is None \
        else jnp.asarray(active, bool).reshape(R)
    _register()
    f32 = jax.ShapeDtypeStruct((R,), jnp.float32)
    out = (f32, jax.ShapeDtypeStruct((R,), jnp.int32), f32, f32)
    return jax.ffi.ffi_call(TARGETS[any_hit], out)(
        nodes, tris, o.astype(jnp.float32), d.astype(jnp.float32), tmax,
        active, tmin=np.float32(tmin), root=np.int32(root))


def walk_packed(nodes, tris, root, o, d, tmin, tmax, any_hit: bool,
                active=None):
    """numpy twin of traverse.cu over the same buffers (ray-parallel,
    one node visit per ray per sweep)."""
    nodes = np.asarray(nodes, np.float32)
    tris = np.asarray(tris, np.float32)
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    R = o.shape[0]
    tcur = np.broadcast_to(np.asarray(tmax, np.float32), (R,)).copy()
    tmin = np.float32(tmin)
    hit_tri = np.full(R, -1, np.int32)
    hu = np.zeros(R, np.float32)
    hv = np.zeros(R, np.float32)
    live = np.ones(R, bool) if active is None \
        else np.asarray(active, bool).reshape(R).copy()
    if root is None:
        live[:] = False
    nref = nodes[:, 12:14].view(np.int32)
    tid = tris[:, 9].view(np.int32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        s = np.where(np.abs(d) < np.float32(1e-12),
                     np.where(d < 0, np.float32(-1e-12), np.float32(1e-12)),
                     d).astype(np.float32)
        inv = (np.float32(1.0) / s).astype(np.float32)
    stack = np.zeros((R, 64), np.int32)
    stack[:, 0] = 0 if root is None else root
    sp = live.astype(np.int32)

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    def slab(idx, lo, hi):
        oo, ii = o[idx], inv[idx]
        a = (lo - oo) * ii
        b = (hi - oo) * ii
        tn = np.minimum(a, b).max(-1)
        tf = np.maximum(a, b).min(-1)
        return (tn <= tf) & (tf >= tmin) & (tn <= tcur[idx]), tn

    while True:
        rays = np.nonzero(sp > 0)[0]
        if rays.size == 0:
            break
        sp[rays] -= 1
        ref = stack[rays, sp[rays]]
        leaf = ref < 0
        lr, slot = rays[leaf], ~ref[leaf]
        if lr.size:
            rec = tris[slot]
            p0, p1, p2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
            dd = d[lr]
            e1, e2 = p1 - p0, p2 - p0
            pvec = cross(dd, e2)
            det = dot(e1, pvec)
            ok = np.abs(det) >= np.float32(1e-9)
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                inv_det = np.float32(1.0) / np.where(ok, det,
                                                     np.float32(1e-9))
                tvec = o[lr] - p0
                u = dot(tvec, pvec) * inv_det
                qvec = cross(tvec, e1)
                v = dot(dd, qvec) * inv_det
                t = dot(e2, qvec) * inv_det
            take = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tmin) \
                & (t <= tcur[lr])
            hr = lr[take]
            tcur[hr] = t[take]
            hit_tri[hr] = tid[slot[take]]
            hu[hr] = u[take]
            hv[hr] = v[take]
            if any_hit:
                sp[hr] = 0
        ir, node = rays[~leaf], ref[~leaf]
        if ir.size:
            rec = nodes[node]
            lhit, lt = slab(ir, rec[:, 0:3], rec[:, 3:6])
            rhit, rt = slab(ir, rec[:, 6:9], rec[:, 9:12])
            l_near = lt <= rt
            lref, rref = nref[node, 0], nref[node, 1]
            for ref_c, ok_c in ((np.where(l_near, rref, lref),
                                 np.where(l_near, rhit, lhit)),
                                (np.where(l_near, lref, rref),
                                 np.where(l_near, lhit, rhit))):
                push = ok_c & (sp[ir] < 64)
                pr = ir[push]
                stack[pr, sp[pr]] = ref_c[push]
                sp[pr] += 1
    missed = hit_tri < 0
    return (np.where(missed, np.float32(np.inf), tcur), hit_tri, hu, hv)


if __name__ == "__main__":
    print(build_library())
