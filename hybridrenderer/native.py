"""Build-and-load for the C++ helpers in ``native/`` (host BVH builder,
OBJ tokenizer).

Each library is compiled from its ``native/*.cpp`` source into
``<checkout>/build/native/`` on first use (``python -m
hybridrenderer.native`` builds them ahead of time). The file name
carries a hash of the source, compiler and flags, so an edited source is
rebuilt and no library from another source or machine is ever loaded.
Portable flags only: the result runs on any x86-64 host. When no C++
compiler is available the callers fall back to their Python paths, with
a warning.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SOURCE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
SOURCES = {"bvh": "bvh_builder.cpp", "loader": "obj_loader.cpp"}
_cache: dict = {}


def library_path(name: str) -> str:
    with open(os.path.join(SOURCE_DIR, SOURCES[name]), "rb") as f:
        key = f.read() + " ".join((CXX, *CXXFLAGS)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhr_{name}_{digest}.so")


def build(name: str) -> str:
    """Compile ``native/<source>`` unless its hashed library exists."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXXFLAGS, "-o", tmp,
           os.path.join(SOURCE_DIR, SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} unavailable: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load(name: str) -> Optional[ctypes.CDLL]:
    """The built library, or None (with a warning) when it cannot be
    built here."""
    if name not in _cache:
        try:
            _cache[name] = ctypes.CDLL(build(name))
        except (RuntimeError, OSError) as e:
            from .runtime.log import core

            core().warning("native %s library unavailable, using the "
                           "Python path: %s", name, e)
            _cache[name] = None
    return _cache[name]


if __name__ == "__main__":
    for n in SOURCES:
        print(build(n))
