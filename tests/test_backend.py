"""The one backend decision (ops/backend.py), the compile-cache rule
(hybridrenderer/__init__.py), the hashed native builds and the device
guard of the measurement paths."""
import os

import pytest

import hybridrenderer
from hybridrenderer import native
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.ops import backend, trace_cuda
from hybridrenderer.ops.trace import SceneTracer
from hybridrenderer.runtime import device
from hybridrenderer.scene import scene as scenes


@pytest.mark.parametrize("platform,expected", [("gpu", "kernel"),
                                               ("cpu", "jnp")])
def test_auto_follows_the_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.resolve("auto") == expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_is_an_error(monkeypatch, platform):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.resolve("auto")


@pytest.mark.parametrize("requested", ["jnp", "kernel"])
@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_explicit_choice_overrides_the_platform(monkeypatch, platform,
                                                requested):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.resolve(requested) == requested


@pytest.mark.parametrize("name", ["pallas", "pallas-wide", "triton", ""])
def test_unknown_backend_name_is_rejected(name):
    with pytest.raises(ValueError):
        backend.resolve(name)


def test_cpu_runs_the_jnp_references():
    data = scenes.cube_scene().build()
    tracer = SceneTracer.build(data, RenderSettings())
    assert tracer.backend == "jnp" and tracer.nodes is None


def test_kernel_tracer_packs_nodes(monkeypatch):
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    data = scenes.cube_scene().build()
    tracer = SceneTracer.build(data, RenderSettings())
    T = data.num_triangles
    assert tracer.backend == "kernel"
    assert tracer.nodes.shape == (T - 1, 16)
    assert tracer.leaf_tris.shape == (T, 12)
    assert tracer.root == 0


def test_compile_cache_follows_the_environment_variable():
    assert hybridrenderer.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_compile_cache_defaults_to_the_checkout():
    d = hybridrenderer.compile_cache_dir({})
    root = os.path.dirname(os.path.dirname(hybridrenderer.__file__))
    assert d == os.path.join(root, ".jax_cache")


def test_native_library_name_tracks_source_and_flags(monkeypatch):
    a = native.library_path("bvh")
    assert a.startswith(native.BUILD_DIR)
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    assert native.library_path("bvh") != a
    assert native.library_path("loader") != a


def test_cuda_library_name_tracks_flags(monkeypatch):
    a = trace_cuda.library_path()
    monkeypatch.setattr(trace_cuda, "NVCC_FLAGS",
                        trace_cuda.NVCC_FLAGS + ("-lineinfo",))
    assert trace_cuda.library_path() != a
    assert "sm_90a" in " ".join(trace_cuda.NVCC_FLAGS)


def test_missing_nvcc_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(trace_cuda, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(trace_cuda, "NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="cannot run"):
        trace_cuda.build_library()
    assert not os.listdir(tmp_path)


def test_measurement_needs_a_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
    assert device.describe()["platform"] == "cpu"
