"""CUDA traversal (ops/trace_cuda.py): the packed node layout and the
numpy walker over it (the kernel's logic, step for step) against the
oracles, the FFI wrapper's argument handling through a stand-in target,
and — on a card only — the compiled kernel itself."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.ops import bvh as bvh_mod
from hybridrenderer.ops import trace, trace_cuda
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scenes

SCENES = {
    "cube": scenes.cube_scene,
    "cornell": scenes.cornell_scene,
    "stress": lambda: scenes.stress_scene(num_objects=6, seed=5),
}


def _setup(scene="cornell", builder="sah", R=2048, seed=23):
    s = SCENES[scene]().build().triangles
    b = bvh_mod.build_bvh_host(s.v0, s.v1, s.v2, builder=builder)
    nodes, tris = trace_cuda.pack_nodes(b, s.v0, s.v1, s.v2)
    rng = np.random.default_rng(seed)
    v0 = np.asarray(s.v0)
    c, ext = v0.mean(0), v0.max(0) - v0.min(0)
    o = (c + rng.normal(0, 0.5, (R, 3)) * ext).astype(np.float32)
    d = rng.normal(0, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return s, b, nodes, tris, o, d


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("builder", ["sah", "lbvh"])
def test_walker_matches_intersect_bvh(builder, any_hit):
    """Same tree, same visit order: visibility and (closest-hit) triangle
    identical; t/u/v within f32 sum-order round-off."""
    s, b, nodes, tris, o, d = _setup(builder=builder)
    ref = trace.intersect_bvh(b, s.v0, s.v1, s.v2, jnp.asarray(o),
                              jnp.asarray(d), 1e-3, 1e6, any_hit=any_hit)
    t, tri, u, v = trace_cuda.walk_packed(nodes, tris, 0, o, d, 1e-3, 1e6,
                                          any_hit)
    np.testing.assert_array_equal(tri >= 0, np.asarray(ref[1]) >= 0)
    if not any_hit:
        np.testing.assert_array_equal(tri, np.asarray(ref[1]))
        hit = tri >= 0
        for a, r in ((t, ref[0]), (u, ref[2]), (v, ref[3])):
            np.testing.assert_allclose(a[hit], np.asarray(r)[hit],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_walker_matches_brute_force(scene, any_hit):
    s, _, nodes, tris, o, d = _setup(scene, R=512, seed=3)
    t_ref, tri_ref, _, _ = trace.intersect_brute(
        s.v0, s.v1, s.v2, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e6)
    t, tri, _, _ = trace_cuda.walk_packed(nodes, tris, 0, o, d, 1e-3, 1e6,
                                          any_hit)
    hit_ref = np.asarray(tri_ref) >= 0
    np.testing.assert_array_equal(tri >= 0, hit_ref)
    if not any_hit:
        np.testing.assert_allclose(t[hit_ref], np.asarray(t_ref)[hit_ref],
                                   rtol=1e-5, atol=1e-5)
        # ties in t may pick either triangle
        assert (tri != np.asarray(tri_ref))[hit_ref].mean() < 0.01


@pytest.mark.parametrize("any_hit", [False, True])
def test_walker_active_mask_and_per_ray_tmax(any_hit):
    s, b, nodes, tris, o, d = _setup(R=1024, seed=9)
    rng = np.random.default_rng(1)
    tmax = rng.uniform(0.5, 20.0, o.shape[0]).astype(np.float32)
    active = rng.uniform(size=o.shape[0]) > 0.3
    t, tri, _, _ = trace_cuda.walk_packed(nodes, tris, 0, o, d, 1e-3, tmax,
                                          any_hit, active)
    assert (tri[~active] == -1).all() and np.isinf(t[~active]).all()
    ref = trace.intersect_bvh(b, s.v0, s.v1, s.v2, jnp.asarray(o),
                              jnp.asarray(d), 1e-3,
                              jnp.where(active, tmax, 0.0), any_hit=any_hit)
    np.testing.assert_array_equal(tri >= 0, np.asarray(ref[1]) >= 0)
    hit = tri >= 0
    assert (t[hit] <= tmax[hit]).all()


def test_single_triangle_scene_roots_at_its_leaf():
    v0 = jnp.asarray([[-1.0, -1.0, 0.0]])
    v1 = jnp.asarray([[1.0, -1.0, 0.0]])
    v2 = jnp.asarray([[0.0, 1.0, 0.0]])
    b = bvh_mod.build_bvh_host(v0, v1, v2)
    nodes, tris = trace_cuda.pack_nodes(b, v0, v1, v2)
    root = trace_cuda.root_ref(1)
    assert root == ~0
    o = np.asarray([[0.0, 0.0, 2.0], [5.0, 5.0, 2.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    t, tri, u, v = trace_cuda.walk_packed(nodes, tris, root, o, d, 1e-3,
                                          1e6, False)
    np.testing.assert_array_equal(tri, [0, -1])
    np.testing.assert_allclose(t[0], 2.0)


def test_empty_scene_misses_everything():
    z = jnp.zeros((0, 3), jnp.float32)
    nodes, tris = trace_cuda.pack_nodes(None, z, z, z)
    assert trace_cuda.root_ref(0) is None
    o = jnp.zeros((5, 3), jnp.float32)
    d = jnp.ones((5, 3), jnp.float32)
    t, tri, u, v = trace_cuda.intersect(nodes, tris, None, o, d, 1e-3, 10.0,
                                        any_hit=False)
    assert (np.asarray(tri) == -1).all() and np.isinf(np.asarray(t)).all()
    t2, tri2, _, _ = trace_cuda.walk_packed(nodes, tris, None, o, d, 1e-3,
                                            10.0, True)
    assert (tri2 == -1).all()


def test_packed_layout_references_every_leaf_once():
    """Each leaf slot is referenced by exactly one internal node and
    holds the triangle the BVH assigned it."""
    s, b, nodes, tris, _, _ = _setup("stress")
    T = s.v0.shape[0]
    refs = np.asarray(nodes)[:, 12:14].view(np.int32).reshape(-1)
    leaves = np.sort(~refs[refs < 0])
    np.testing.assert_array_equal(leaves, np.arange(T))
    internal = np.sort(refs[refs >= 0])
    np.testing.assert_array_equal(internal, np.arange(1, T - 1))
    tid = np.asarray(tris)[:, 9].view(np.int32)
    np.testing.assert_array_equal(tid, np.asarray(b.tri)[T - 1:])
    np.testing.assert_array_equal(np.asarray(tris)[:, 0:3],
                                  np.asarray(s.v0)[tid])


def _fake_ffi(monkeypatch):
    """Stand-in for the CUDA target: the same operands and attributes,
    answered by the numpy walker through a host callback."""
    calls = []

    def ffi_call(target, out):
        def call(nodes, tris, o, d, tmax, active, *, tmin, root):
            calls.append(dict(target=target, shapes=[
                x.shape for x in (nodes, tris, o, d, tmax, active)],
                dtypes=[x.dtype for x in (o, d, tmax, active)],
                tmin=tmin, root=root))
            any_hit = target == trace_cuda.TARGETS[True]

            def host(nodes, tris, o, d, tmax, active):
                return tuple(np.asarray(x) for x in trace_cuda.walk_packed(
                    nodes, tris, int(root), o, d, float(tmin), tmax,
                    any_hit, active))

            return jax.pure_callback(host, out, nodes, tris, o, d, tmax,
                                     active)
        return call

    monkeypatch.setattr(trace_cuda, "_register", lambda: None)
    monkeypatch.setattr(jax.ffi, "ffi_call", ffi_call)
    return calls


@pytest.mark.parametrize("any_hit", [False, True])
def test_wrapper_broadcasts_tmax_and_defaults_active(monkeypatch, any_hit):
    calls = _fake_ffi(monkeypatch)
    s, b, nodes, tris, o, d = _setup(R=300)
    t, tri, u, v = trace_cuda.intersect(nodes, tris, 0, jnp.asarray(o),
                                        jnp.asarray(d), 0.01, 50.0, any_hit)
    (c,) = calls
    assert c["target"] == trace_cuda.TARGETS[any_hit]
    assert c["shapes"][2:] == [(300, 3), (300, 3), (300,), (300,)]
    assert c["dtypes"] == [jnp.float32, jnp.float32, jnp.float32, bool]
    assert c["tmin"].dtype == np.float32 and c["root"].dtype == np.int32
    ref = trace_cuda.walk_packed(nodes, tris, 0, o, d, 0.01, 50.0, any_hit)
    np.testing.assert_array_equal(np.asarray(tri), ref[1])


def test_wrapper_passes_active_mask(monkeypatch):
    calls = _fake_ffi(monkeypatch)
    s, b, nodes, tris, o, d = _setup(R=256)
    active = np.arange(256) % 3 != 0
    t, tri, _, _ = trace_cuda.intersect(
        nodes, tris, 0, jnp.asarray(o), jnp.asarray(d), 1e-3,
        jnp.full((256,), 1e6), False, active=jnp.asarray(active))
    assert calls
    assert (np.asarray(tri)[~active] == -1).all()


@pytest.mark.parametrize("path,flags", [
    (RenderPathType.HYBRID, RenderFlags.default_hybrid()),
    (RenderPathType.HYBRID, RenderFlags.default_hybrid()
     | RenderFlags.REFLECTION | RenderFlags.GI),
    (RenderPathType.RAYTRACED, RenderFlags.LIGHT | RenderFlags.IBL
     | RenderFlags.TAA | RenderFlags.EMISSIVE),
])
def test_frame_through_kernel_wrapper_matches_jnp(monkeypatch, path, flags):
    """A whole frame with trace_backend="kernel" (the walker standing in
    for the card) renders the same image as the jnp traversal. Hit t/u/v
    agree to f32 round-off, and a 1-ulp shift of a hit point can flip a
    grazing secondary (shadow / NEE) ray, so a handful of pixels may
    differ; everything else matches."""
    _fake_ffi(monkeypatch)
    data = scenes.cornell_scene().build()
    cam = OrbitCamera(width=48, height=40, distance=13.0,
                      focal_point=(0, 2.5, 0)).step()
    imgs = []
    for tb in ("jnp", "kernel"):
        st = RenderSettings(width=48, height=40, path=path, flags=flags,
                            trace_backend=tb, raster_backend="jnp")
        r = Renderer.for_scene(st, data)
        assert r.tracer.backend == tb
        imgs.append(np.asarray(r.render(cam)))
    off = np.abs(imgs[1] - imgs[0]).max(-1) > 2e-3
    assert off.mean() < 0.005, f"{off.sum()} pixels differ"


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_matches_walker(gpu_device, any_hit):
    s, b, nodes, tris, o, d = _setup(R=4096)
    with jax.default_device(gpu_device):
        out = trace_cuda.intersect(nodes, tris, 0, jnp.asarray(o),
                                   jnp.asarray(d), 1e-3, 1e6, any_hit)
    ref = trace_cuda.walk_packed(nodes, tris, 0, o, d, 1e-3, 1e6, any_hit)
    np.testing.assert_array_equal(np.asarray(out[1]) >= 0, ref[1] >= 0)
    if not any_hit:
        np.testing.assert_array_equal(np.asarray(out[1]), ref[1])
