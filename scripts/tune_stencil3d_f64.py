"""Tile and ring variants of the f64 streaming 3d stencil kernel on one
CUDA card, at the main path's shapes, and the main path with the
streaming kernel against the one-thread-per-vertex kernel it replaced.

    python3 scripts/tune_stencil3d_f64.py [--main-path]

Instantiates the kernel template of
``cracks_tpu_torch/csrc/lattice_stencil3d_stream.cuh`` with each variant
below (ring slots, tile rows; TMA boxes or the 8-byte cp.async copies
that odd rows take) in one library built here with nvcc, beside the
one-thread-per-vertex kernel of
``csrc/lattice_stencil3d.cu`` instantiated for f64 (the f64 entry point
before the streaming kernel).  For the four f64 products of the
refinement residual at 80^3 cells (the u block, the phase-field block,
J_pu and J_up), checks every variant and the library's own entry point
bit for bit against that kernel and times them: CUDA events around one
launch queued behind a device-side sleep, so the time is the card's
alone, the L2 flushed before each by reading 128 MB that nothing
writes (``cracks_tpu_torch/kernel_clock.py``), median of 15 rounds taken in
turns over the variants.  Prints the card's name and power limit
first, then one line per variant with its bound (the bytes of the J
block, X and Y over 3.35 TB/s), and the host time per call of the f64
entry point (200 calls queued back to back; it encodes the TMA tensor
map at each call).

`--main-path` then runs the Sneddon 3d refine-3 main path (2,125,764
DoFs, two load steps), replicated and with dof_sharding = lattice on 4
shards, once with the f64 products on the one-thread-per-vertex kernel
and once on the streaming kernel (replicated: old, new, new, old), and
prints each run's energies to the last bit, its Newton and linear
iterations, f64 launches (in all and per (k_in, k_out) block), seconds
per step and peak device memory.
"""

import argparse
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
CELLS = (80, 80, 80)
BLOCKS = {}                    # f64 launches per (k_in, k_out) of a run
# (name, lo_r, hi_r, lo_c, hi_c, k_in, k_out) -> variants (ring slots,
# tile rows, 8-byte copies in place of TMA); the first of each is what
# the library's f64 entry point launches
CASES = {
    ("f64 u block", 0, 24, 0, 24, 3, 3):
        [(1, 3, False), (1, 1, False), (1, 2, False), (1, 4, False),
         (2, 1, False), (2, 2, False), (2, 3, False), (3, 1, False),
         (4, 1, False), (1, 3, True)],
    ("f64 J_pu block", 24, 32, 0, 24, 3, 1):
        [(1, 3, False), (1, 1, False), (1, 2, False), (1, 4, False),
         (2, 1, False), (2, 2, False), (2, 3, False), (4, 1, False),
         (1, 3, True)],
    ("f64 phi block", 24, 32, 24, 32, 1, 1):
        [(1, 2, False), (1, 1, False), (1, 3, False), (1, 4, False),
         (2, 2, False), (4, 2, False), (8, 2, False), (1, 2, True)],
    ("f64 J_up block", 0, 24, 24, 32, 1, 3):
        [(2, 2, False), (1, 2, False), (1, 3, False), (2, 1, False),
         (2, 3, False), (4, 2, False), (2, 2, True)],
}
ARGS = ("const double* J, const double* X, double* Y, int R, int C, "
        "int GCZ, int GCY, int GCX, int lo_r, int lo_c, void* stream")
CALL = "J, X, Y, R, C, GCZ, GCY, GCX, lo_r, lo_c"


def _variant_name(k_in, k_out, v):
    stages, ty, copies8 = v
    return (f"stream_k{k_in}{k_out}_slots{stages}_ty{ty}"
            f"{'_cpasync8' if copies8 else '_tma'}")


def build_variants():
    """One library with an entry point per variant, one per block for the
    one-thread-per-vertex kernel in f64, and that kernel's dispatcher
    under the f64 entry point's signature; returns it."""
    lines = ['#include "lattice_stencil3d.cu"', ""]
    for (_, _, _, _, _, k_in, k_out), variants in CASES.items():
        lines.append(
            f'extern "C" int pr2_k{k_in}{k_out}({ARGS}) {{\n'
            "  (void)R;\n"
            f"  launch<double, {k_in}, {k_out}>("
            "J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, "
            "static_cast<cudaStream_t>(stream));\n"
            "  return static_cast<int>(cudaGetLastError());\n}")
        for v in variants:
            stages, ty, copies8 = v
            lines.append(
                f'extern "C" int {_variant_name(k_in, k_out, v)}({ARGS}) {{\n'
                f"  return stream3d::launch<{k_in}, {k_out}, {stages}>("
                f"{CALL}, {ty}, static_cast<cudaStream_t>(stream), "
                f"{'true' if copies8 else 'false'});\n}}")
    lines.append(
        'extern "C" int pr2_lattice_stencil3d_f64(const double* J, '
        "const double* X, double* Y, int R, int C, int GCZ, int GCY, "
        "int GCX, int lo_r, int lo_c, int k_in, int k_out, void* stream) {\n"
        "  return dispatch<double>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r, lo_c, "
        "k_in, k_out, stream);\n}")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "tune_stencil3d_f64.cu")
    lib = os.path.join(kernels.BUILD_DIR, "libtune_stencil3d_f64.so")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                           "-I", kernels.SRC_DIR, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    print(f"nvcc {time.perf_counter() - t0:.1f} s")
    print("\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                    if "registers" in line or "spill" in line
                    or "Compiling entry" in line))
    return ctypes.CDLL(lib)


def _entry(lib, name, n_ints):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sweep(lib):
    """Check every variant bit for bit and time it."""
    dev = torch.device("cuda")
    clock = KernelClock(dev)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    ndl = 32
    grid = tuple(c + 1 for c in CELLS)
    jac = torch.as_tensor(rng.standard_normal((ndl, ndl) + CELLS,
                                              dtype=np.float32),
                          device=dev).to(torch.float64)
    x = torch.as_tensor(rng.standard_normal((3,) + grid), device=dev)
    R, C = jac.shape[:2]
    for (name, lo_r, hi_r, lo_c, hi_c, k_in, k_out), variants in \
            CASES.items():
        X = x[:k_in].contiguous()
        args = (lo_r, hi_r, lo_c, hi_c, k_in, k_out)

        def raw(fn, Y):
            def call():
                err = fn(jac.data_ptr(), X.data_ptr(), Y.data_ptr(), R, C,
                         *CELLS, lo_r, lo_c, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return Y
            return call
        fns = {"pr2": raw(_entry(lib, f"pr2_k{k_in}{k_out}", 7),
                          torch.empty((k_out,) + grid, dtype=torch.float64,
                                      device=dev))}
        y_ref = fns["pr2"]().clone()
        for v in variants:
            vname = _variant_name(k_in, k_out, v)
            fns[vname] = raw(_entry(lib, vname, 7),
                             torch.empty_like(y_ref))
        fns["entry point (stencil_matvec)"] = (
            lambda: stencil.stencil_matvec(jac, X, *args))
        for vname, fn in fns.items():
            y = fn()
            torch.cuda.synchronize()
            if not torch.equal(y, y_ref):
                diff = float((y - y_ref).abs().max())
                raise AssertionError(f"{name} {vname} differs from the "
                                     f"one-thread-per-vertex kernel, max "
                                     f"|diff| {diff:.3e}")
        nbytes = ((hi_r - lo_r) * (hi_c - lo_c) * int(np.prod(CELLS))
                  + (k_in + k_out) * int(np.prod(grid))) * 8
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        times = {n: [] for n in fns}
        for _ in range(3):
            for fn in fns.values():
                fn()
        for _ in range(15):
            for n, fn in fns.items():
                times[n].append(clock.once_ms(fn))
        for n, t in times.items():
            us = statistics.median(t) * 1e3
            print(f"{name} {n}: {us:.1f} us (min {min(t) * 1e3:.1f}), bound "
                  f"{bound_us:.1f} us ({nbytes / 1e6:.1f} MB), "
                  f"{100 * bound_us / us:.1f} % of bound; bit for bit "
                  "equal to pr2")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            stencil.stencil_matvec(jac, X, *args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"{name} host time per call of the f64 entry point: "
              f"{host_us:.1f} us")
        del fns, y_ref, X
        torch.cuda.empty_cache()
    del jac, x, clock
    torch.cuda.empty_cache()


def _run(overrides):
    """One 3d refine-3 run on the card; its energies, iterations, f64
    launches (in all and per (k_in, k_out) block), seconds per step and
    peak memory."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    p = config.load_parameters(
        os.path.join(REPO, "params", "parameters_sneddon_3d.prm"),
        n_global_pre_refine=3, n_local_pre_refine=0, n_refinement_cycles=0,
        max_no_timesteps=1, output_dir="", linear_solver="cg",
        preconditioner="gmg", cg_rtol=1e-8, cg_maxiter=3000,
        dtype="float64", mixed_precision_cg=True, **overrides)
    sim = Simulation(p, device="cuda", verbose=False)
    torch.cuda.reset_peak_memory_stats()
    stencil.stencil_matvec3d.f64_launches = 0
    BLOCKS.clear()
    sim.run()
    torch.cuda.synchronize()
    d = sim.statistics.data
    out = dict(energies=[float(v) for v in d["Bulk Energy"]
                         + d["Crack Energy"]],
               its=[(e[1], e[2]) for e in sim.solver_effort],
               f64=stencil.stencil_matvec3d.f64_launches, blocks=dict(BLOCKS),
               secs=[t[2] for t in sim.step_times],
               peak=torch.cuda.max_memory_allocated())
    del sim
    torch.cuda.empty_cache()
    return out


def _counted(fn):
    """fn, an f64 entry point, counting its launches per (k_in, k_out)
    in BLOCKS."""
    def call(*args):
        key = tuple(args[-3:-1])
        BLOCKS[key] = BLOCKS.get(key, 0) + 1
        return fn(*args)
    return call


def main_path(lib):
    """The 3d refine-3 main path with the f64 products on the old and the
    new kernel, energies to the last bit."""
    new = kernels.lattice_stencil3d()
    old = kernels.StencilLib(
        "pr2 f64", lib, new.f32,
        _counted(_entry(lib, "pr2_lattice_stencil3d_f64", 9)))
    new = new._replace(f64=_counted(new.f64))
    libs = {"one-thread-per-vertex": lambda: old, "streaming": lambda: new}
    loader = kernels.lattice_stencil3d
    plans = [({}, ["one-thread-per-vertex", "streaming", "streaming",
                   "one-thread-per-vertex"]),
             (dict(n_devices=4, dof_sharding="lattice"),
              ["one-thread-per-vertex", "streaming"])]
    try:
        for overrides, order in plans:
            label = "sharded D=4" if overrides else "replicated"
            runs = []
            for which in order:
                kernels.lattice_stencil3d = libs[which]
                r = _run(overrides)
                runs.append((which, r))
                print(f"3d refine 3 {label}, f64 on the {which} kernel: "
                      f"energies {[repr(e) for e in r['energies']]}, "
                      f"Newton/linear its {r['its']}, f64 launches "
                      f"{r['f64']} (per (k_in, k_out) {r['blocks']}), "
                      f"s/step {r['secs']}, peak {r['peak']} B")
            base = runs[0][1]["energies"]
            for which, r in runs[1:]:
                same = r["energies"] == base
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(r["energies"], base))
                print(f"3d refine 3 {label}: {which} vs {runs[0][0]}: "
                      f"energies bit-equal {same}, max rel {rel:.3e}, "
                      f"iterations equal {r['its'] == runs[0][1]['its']}")
    finally:
        kernels.lattice_stencil3d = loader


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--main-path", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    lib = build_variants()
    sweep(lib)
    if opts.main_path:
        main_path(lib)


if __name__ == "__main__":
    main()
