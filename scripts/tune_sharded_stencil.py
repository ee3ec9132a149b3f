"""Tile, ring and box variants of the row-slab sharded stencil kernels on
one CUDA card, at the main paths' shapes.

    python3 scripts/tune_sharded_stencil.py

Instantiates the kernel template of
``cracks_tpu_torch/csrc/lattice_stencil_sharded.cuh`` with each variant
below (ring stages, tile rows) in one library built here with nvcc,
then, for
the four f32 products the sharded solve runs (2d u and phase-field
blocks at 640² cells, 3d at 80³ cells, D = 4 shards), checks each
variant bit for bit against the unsharded kernel and times it on
``cracks_tpu_torch/kernel_clock.py``'s clock (CUDA events around one
launch queued behind a device-side sleep, so the time is the card's
alone, not the host's enqueue; the L2 flushed before each by reading
128 MB that nothing writes), median of 15 rounds taken in turns over
the variants.  The
unsharded kernel is timed the same way.  Prints the card's name and
power limit first and one line per variant.  Last, the host time per
call of the sharded and the unsharded wrapper (200 calls queued back
to back), which the device clock above leaves out.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cracks_tpu_torch import kernels  # noqa: E402
from cracks_tpu_torch.kernel_clock import KernelClock  # noqa: E402
from cracks_tpu_torch.ops import stencil  # noqa: E402
from cracks_tpu_torch.parallel.sharding import make_shard_mesh  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
D_SHARDS = 4
# (dim, k, lo, hi, cells) -> variants (ring stages, tile rows); the
# first of each is the one the kernel's source launches
CASES = {
    (2, 2, 0, 8, (640, 640)): [(2, 2), (4, 2), (1, 2), (4, 4)],
    (2, 1, 8, 12, (640, 640)): [(2, 4), (4, 4), (1, 4), (4, 8)],
    (3, 3, 0, 24, (80, 80, 80)): [(2, 1), (1, 1), (4, 1), (8, 1)],
    (3, 1, 24, 32, (80, 80, 80)): [(4, 2), (8, 2), (2, 2), (2, 1)],
}


def _variant_name(dim, k, v):
    stages, ty = v
    return f"v{dim}d_k{k}_stages{stages}_ty{ty}"


def build_variants():
    """One library with an entry point per variant; returns it."""
    lines = ['#include "lattice_stencil_sharded.cuh"', ""]
    for (dim, k, _, _, _), variants in CASES.items():
        for v in variants:
            stages, ty = v
            lines.append(
                f'extern "C" int {_variant_name(dim, k, v)}(const float* JP, '
                "const float* X, float* Y, int D, int rl, int G0, int GY, "
                "int GX, int GCXp, void* stream) {\n"
                f"  return sharded::launch<float, {dim}, {k}, {stages}>("
                f"JP, X, nullptr, nullptr, Y, D, rl, 0, G0, G0, GY, GX, "
                f"GCXp, {ty}, "
                "static_cast<cudaStream_t>(stream));"
                "\n}")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "tune_sharded_stencil.cu")
    lib = os.path.join(kernels.BUILD_DIR, "libtune_sharded_stencil.so")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                           "-I", kernels.SRC_DIR, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    print("\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                    if "registers" in line or "spill" in line))
    return ctypes.CDLL(lib)


def _host_us(jac, X, JP, k, mesh, calls=200):
    """Host time per call of the sharded and the unsharded wrapper, and
    of the sharded wrapper's validation alone: `calls` calls queued
    back to back, the host clock read before the final synchronize."""
    kl = JP.shape[1]
    fns = {"host, sharded wrapper": lambda: stencil.stencil_matvec_sharded(
               JP, X, k, mesh),
           "host, unsharded wrapper": lambda: stencil.stencil_matvec(
               jac, X, 0, kl, 0, kl, k, k),
           "host, check_sharded": lambda: stencil.check_sharded(
               JP, X, k, mesh)}
    out = {}
    for name, fn in fns.items():
        fn()                            # the first call builds the library
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    lib = build_variants()
    dev = torch.device("cuda")
    mesh = make_shard_mesh([dev] * D_SHARDS)
    clock = KernelClock(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for (dim, k, lo, hi, cells), variants in CASES.items():
        rng = np.random.default_rng(0)
        kl = hi - lo
        grid = tuple(c + 1 for c in cells)
        jac = torch.as_tensor(rng.standard_normal((kl, kl) + cells,
                                                  dtype=np.float32),
                              device=dev)
        X = torch.as_tensor(rng.standard_normal((k,) + grid,
                                                dtype=np.float32),
                            device=dev)
        y_ref = stencil.stencil_matvec(jac, X, 0, kl, 0, kl, k, k)
        JP = stencil.pad_jac_sharded(jac, 0, kl, 0, kl, mesh)
        rl = JP.shape[3] - 1
        gy, gx = (1, grid[1]) if dim == 2 else grid[1:]
        nbytes = (JP.numel() + 2 * X.numel()) * 4
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        fns = {}
        for v in variants:
            fn = getattr(lib, _variant_name(dim, k, v))
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            Y = torch.empty_like(X)

            def call(fn=fn, Y=Y):
                err = fn(JP.data_ptr(), X.data_ptr(), Y.data_ptr(),
                         D_SHARDS, rl, grid[0], gy, gx, JP.shape[-1],
                         stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: {err}")
                return Y
            call()
            torch.cuda.synchronize()
            if not torch.equal(call(), y_ref):
                raise AssertionError(f"{_variant_name(dim, k, v)} differs "
                                     "from the unsharded kernel")
            fns[_variant_name(dim, k, v)] = call
        fns["unsharded kernel"] = lambda: stencil.stencil_matvec(
            jac, X, 0, kl, 0, kl, k, k)
        times = {name: [] for name in fns}
        for _ in range(3):
            for fn in fns.values():
                fn()
        for _ in range(15):
            for name, fn in fns.items():
                times[name].append(clock.once_ms(fn))
        times.update(_host_us(jac, X, JP, k, mesh))
        for name, t in times.items():
            if name.startswith("host"):
                print(f"{dim}d k={k} {name}: {t:.1f} us per call")
                continue
            us = statistics.median(t) * 1e3
            line = (f"{dim}d k={k} {name}: {us:.1f} us (min "
                    f"{min(t) * 1e3:.1f}), carrier bound {bound_us:.1f} us "
                    f"({nbytes / 1e6:.1f} MB), {100 * bound_us / us:.1f} % "
                    "of bound")
            print(line)
        del jac, X, JP, y_ref, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
