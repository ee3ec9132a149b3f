"""Native (C++) forest core: loader and ctypes bindings.

The port's copy of ``cracks_tpu/native``: the hot mesh-administration
primitive (canonical lattice-point keys, see forest.cpp) in C++,
compiled on first use with the host's C++ compiler into
``cracks_tpu_torch/build/`` (git-ignored) and loaded through ctypes.
When no compiler is available the callers fall back to the vectorized
numpy implementation in ``cracks_tpu_torch/mesh.py``; the results are
bit-identical (tests/test_torch_host.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "forest.cpp")
_SO = os.path.join(os.path.dirname(_DIR), "build", "libforest.so")
_lib = None
_tried = False


def _build() -> bool:
    """Compile forest.cpp into build/libforest.so (through a per-process
    temporary name, so concurrent builders never load a partial file)."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0 or not os.path.exists(tmp):
        return False
    os.replace(tmp, _SO)
    return True


def get_lib():
    """The loaded shared library, building it if necessary; None when
    no compiler is available."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                   < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.canonical_keys.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_void_p, ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.canonical_keys.restype = None
    _lib = lib
    return _lib


def canonical_keys(dim: int, S: int, L: int, K: int, root: np.ndarray,
                   coords: np.ndarray, cells: np.ndarray,
                   face_uid: np.ndarray | None,
                   root_face_vids: np.ndarray | None) -> np.ndarray | None:
    """Native canonical_keys; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(root)
    root = np.ascontiguousarray(root, np.int64)
    coords = np.ascontiguousarray(coords, np.int64)
    out = np.empty(n, np.int64)
    if dim == 3:
        fu = np.ascontiguousarray(face_uid, np.int64)
        rfv = np.ascontiguousarray(root_face_vids, np.int64)
        fu_p = fu.ctypes.data_as(ctypes.c_void_p)
        rfv_p = rfv.ctypes.data_as(ctypes.c_void_p)
    else:
        fu = rfv = None
        fu_p = rfv_p = None
    lib.canonical_keys(dim, S, L, K, n, root, coords,
                       np.ascontiguousarray(cells, np.int64), fu_p, rfv_p,
                       out)
    return out
