"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface in
``cracks_tpu_torch/build/`` (git-ignored), at first use, and loaded
with ``ctypes``.  A library older than its source is rebuilt.  A failed
build raises with the compiler's output; nothing is retried.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

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
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
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


@functools.cache
def lattice_stencil() -> ctypes.CDLL:
    """The loaded lattice-stencil library (csrc/lattice_stencil.cu)."""
    path, _ = build("lattice_stencil")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lattice_stencil_f32, lib.lattice_stencil_f64):
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return lib
