"""ctypes bindings of the repository's native C++ components (a copy of the
JAX package's native/__init__.py): OBJ parsing (native/mesh_loader.cpp, the
analog of src/shapes/obj.cpp) and the LBVH build (native/lbvh.cpp, the
analog of gkdtree.h's threaded builder).

The sources are read in place from `native/` and compiled with the host's
g++ into `mitsuba_tpu_torch/_build/` (git-ignored), named by a hash of the
sources and flags, at first use; a concurrent build never loads a
half-written library (it is renamed into place). `io/mesh.load_obj` and
`scene/bvh.build_bvh` take the library where it builds and their numpy
code, which gives the same arrays, where it does not (`available()`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("mesh_loader.cpp", "lbvh.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's flags but -march=native: the library's name hashes the
# sources and flags, not the machine, so it is built for any x86-64
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_lib = None
_build_error = None


def build() -> Path:
    """Compile native/*.cpp unless a library of the same sources and flags
    exists. Returns its path; raises with the compiler's output when the
    build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    lib = BUILD_DIR / f"libmitsuba_native-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(str(NATIVE_DIR / n) for n in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    """The loaded library, built at the first call; None where it cannot be
    built or loaded (`build_error()` says why)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        _build_error = f"{type(e).__name__}: {e}"
        return None
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_F), ctypes.POINTER(_F),
                              ctypes.POINTER(_F), ctypes.POINTER(_I), ctypes.POINTER(i64),
                              ctypes.POINTER(i64), ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.parse_obj.restype = ctypes.c_int
    lib.mesh_free.argtypes = [_F, _F, _F, _I]
    lib.mesh_free.restype = None
    lib.build_lbvh.argtypes = [_F, i64, _I, i64, i32, ctypes.POINTER(_F), ctypes.POINTER(_F),
                               ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(i64),
                               ctypes.POINTER(i64)]
    lib.build_lbvh.restype = ctypes.c_int
    lib.bvh_free.argtypes = [_F, _F, _I, _I]
    lib.bvh_free.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error():
    """Why the library is not available (None where it is, or before the
    first use)."""
    return _build_error


def parse_obj(path):
    """Native OBJ parse -> dict of numpy arrays (vertices, normals or None,
    uvs or None, indices), or None where the library is not available or
    the file cannot be read. Keeps no usemtl groups."""
    lib = _load()
    if lib is None:
        return None
    pos, nrm, uv, idx = _F(), _F(), _F(), _I()
    nverts, ntris = ctypes.c_int64(), ctypes.c_int64()
    has_n, has_uv = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.parse_obj(str(path).encode(), ctypes.byref(pos), ctypes.byref(nrm),
                       ctypes.byref(uv), ctypes.byref(idx), ctypes.byref(nverts),
                       ctypes.byref(ntris), ctypes.byref(has_n), ctypes.byref(has_uv))
    if rc != 0:
        return None
    nv, nt = nverts.value, ntris.value
    if nv == 0 or nt == 0:
        lib.mesh_free(pos, nrm, uv, idx)
        return {"vertices": np.zeros((0, 3), np.float32), "normals": None, "uvs": None,
                "indices": np.zeros((0, 3), np.int32)}
    try:
        return {
            "vertices": np.ctypeslib.as_array(pos, (nv, 3)).copy(),
            "normals": np.ctypeslib.as_array(nrm, (nv, 3)).copy() if has_n.value else None,
            "uvs": np.ctypeslib.as_array(uv, (nv, 2)).copy() if has_uv.value else None,
            "indices": np.ctypeslib.as_array(idx, (nt, 3)).copy(),
        }
    finally:
        lib.mesh_free(pos, nrm, uv, idx)


def build_lbvh(vertices: np.ndarray, indices: np.ndarray, leaf_size: int):
    """Native BVH build -> (aabb_min, aabb_max, miss, order), the arrays of
    scene/bvh.build_bvh's numpy build, or None where the library is not
    available."""
    lib = _load()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    amin, amax, miss, order = _F(), _F(), _I(), _I()
    nodes, cap = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.build_lbvh(vertices.ctypes.data_as(_F), vertices.shape[0],
                        indices.ctypes.data_as(_I), indices.shape[0], int(leaf_size),
                        ctypes.byref(amin), ctypes.byref(amax), ctypes.byref(miss),
                        ctypes.byref(order), ctypes.byref(nodes), ctypes.byref(cap))
    if rc != 0:
        return None
    m_, c_ = nodes.value, cap.value
    try:
        return (np.ctypeslib.as_array(amin, (m_, 3)).copy(),
                np.ctypeslib.as_array(amax, (m_, 3)).copy(),
                np.ctypeslib.as_array(miss, (m_,)).copy(),
                np.ctypeslib.as_array(order, (c_,)).copy())
    finally:
        lib.bvh_free(amin, amax, miss, order)
