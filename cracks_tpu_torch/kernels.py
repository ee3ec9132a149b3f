"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface in
``cracks_tpu_torch/build/`` (git-ignored), at first use, and loaded
with ``ctypes``.  A library older than its source, or than a header
(``*.cuh``) in ``csrc/``, is rebuilt.  A failed build raises with the
compiler's output; nothing is retried.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import NamedTuple

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless an
    up-to-date library exists.  Returns (library path, compiler output;
    empty when nothing was compiled)."""
    src = os.path.join(SRC_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                    if f.endswith(".cuh")]
    if (os.path.exists(lib) and os.path.getmtime(lib)
            >= max(os.path.getmtime(f) for f in deps)):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class StencilLib(NamedTuple):
    """A loaded stencil library and its two entry points, f32 and f64:
    `n_ptrs` pointers, `n_ints` ints and the stream, returning a
    cudaError_t (see each loader)."""

    name: str
    lib: ctypes.CDLL
    f32: object
    f64: object


def _load_stencil(name: str, n_ints: int, n_ptrs: int = 3) -> StencilLib:
    path, _ = build(name)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = []
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"{name}_{dt}")
        fn.argtypes = [p] * n_ptrs + [i] * n_ints + [p]
        fn.restype = i
        fns.append(fn)
    return StencilLib(name, lib, *fns)


@functools.cache
def lattice_stencil() -> StencilLib:
    """The 2d lattice-stencil library (csrc/lattice_stencil.cu):
    ``(J, X, Y, R, C, GCY, GCX, lo_r, lo_c, k_in, k_out, stream)``."""
    return _load_stencil("lattice_stencil", 8)


@functools.cache
def lattice_stencil3d() -> StencilLib:
    """The 3d lattice-stencil library (csrc/lattice_stencil3d.cu):
    ``(J, X, Y, R, C, GCZ, GCY, GCX, lo_r, lo_c, k_in, k_out, stream)``."""
    return _load_stencil("lattice_stencil3d", 9)


@functools.cache
def lattice_stencil_sharded() -> StencilLib:
    """The 2d row-slab sharded library (csrc/lattice_stencil_sharded.cu):
    ``(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GX, GCXp, k, stream)``
    (Xlo, Xhi: halo rows or null)."""
    return _load_stencil("lattice_stencil_sharded", 8, n_ptrs=5)


@functools.cache
def lattice_stencil3d_sharded() -> StencilLib:
    """The 3d row-slab sharded library
    (csrc/lattice_stencil3d_sharded.cu):
    ``(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GY, GX, GCXp, k,
    stream)``."""
    return _load_stencil("lattice_stencil3d_sharded", 9, n_ptrs=5)
