"""The 2d stencil library of two source trees on one CUDA card, side by
side, for the phase-field products (k_in = k_out = 1), and variants of
this tree's phase-field kernel.

    git archive <commit> cracks_tpu_torch/csrc | tar -x -C <dir>
    python3 scripts/ab_stencil2d.py <dir>/cracks_tpu_torch/csrc

Builds ``lattice_stencil.cu`` of the given source directory (the parent,
say) and of this tree's ``cracks_tpu_torch/csrc`` with the port's nvcc
flags into two libraries; this tree's also gets one entry point per
variant of the phase-field kernel (``lattice_stencil2d_phi.cuh``: threads
per CTA, single-value J loads) and the read yardsticks below.  Prints
the card's name and power limit first, what ptxas says of the
phase-field kernels and the order of the memory instructions in the f32
entry kernel's SASS, then:

1. for the f32 and f64 phase-field products at every GMG level of the
   2d main path (640^2 down to 10^2 cells, seeded inputs), whether the
   two libraries give the same bits, and their times in the order
   parent, this tree, this tree, parent, 20 rounds, on
   ``cracks_tpu_torch/kernel_clock.py``'s clock twice: with the L2
   flushed by a read (clean) and by a write (dirty): medians, the
   median over rounds of this tree's time less the parent's and how
   many rounds this tree won, and the bound (J block + X + Y over 3.35
   TB/s, the H100 SXM data sheet);
2. at 640^2, 320^2 and 160^2 cells, every variant and the row-slab
   sharded kernel at D = 1 and 4 (TMA ring; one launch) held bit for bit
   against the entry point and timed on the clean clock, 15 rounds in
   turns, beside yardsticks that compute nothing: kernels that read the
   block's 16 planes once (16-byte or single-value loads) or as many
   contiguous bytes, and store nothing (what reading J alone takes on
   this clock), and an empty launch (the clock's floor).
"""

import ctypes
import os
import re
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
LEVELS = (640, 320, 160, 80, 40, 20, 10)   # cells a side, finest first
VARIANT_LEVELS = (640, 320, 160)
LO = 8                         # the phase-field block: rows/cols 8..11
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# name -> (threads per CTA, values per J load (0: 16 bytes)); the first
# is what the entry point runs
VARIANTS = {
    "t64": (64, 0),
    "t128": (128, 0),
    "t256": (256, 0),
    "t64 single-value loads": (64, 1),
}
ROUNDS = 20                    # parent / this tree / this tree / parent
ARGS = ("const {t}* J, const {t}* X, {t}* Y, int R, int C, int GCY, "
        "int GCX, int lo_r, int lo_c, void* stream")
# read yardsticks: the 16 planes of the block read once, as 16-byte or
# single-value loads (16 per thread, all issued before any use), summed
# and stored only on an impossible value, so the kernel moves the
# product's J bytes and nothing else
PROBE = """
template <typename T, typename U>
__global__ void __launch_bounds__(256)
read_probe(const T* __restrict__ J, T* Y, int C, int64_t plane, int lo_r,
           int lo_c, int64_t n) {
  const int64_t t = blockIdx.x * 256ll + threadIdx.x;
  if (t >= n) return;
  U v[16];
#pragma unroll
  for (int p = 0; p < 16; ++p)
    v[p] = __ldg(reinterpret_cast<const U*>(
        J + ((int64_t)(lo_r + p / 4) * C + lo_c + p % 4) * plane) + t);
  T acc = T(0);
  const T* w = reinterpret_cast<const T*>(v);
#pragma unroll
  for (int k = 0; k < 16 * (int)(sizeof(U) / sizeof(T)); ++k) acc += w[k];
  if (acc == T(1.2345e-30)) Y[0] = acc;
}
template <typename T, typename U>
__global__ void __launch_bounds__(256)
read_probe_flat(const T* __restrict__ J, T* Y, int64_t n) {
  // warp w reads 16 consecutive 32-unit runs: 16 x 32 units contiguous
  const int64_t w = (blockIdx.x * 256ll + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  U v[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int64_t i = (w * 16 + p) * 32 + lane;
    v[p] = i < n ? __ldg(reinterpret_cast<const U*>(J) + i) : U{};
  }
  T acc = T(0);
  const T* x = reinterpret_cast<const T*>(v);
#pragma unroll
  for (int k = 0; k < 16 * (int)(sizeof(U) / sizeof(T)); ++k) acc += x[k];
  if (acc == T(1.2345e-30)) Y[0] = acc;
}
template <typename T, typename U>
int probe_flat(const T* J, T* Y, int GCY, int GCX, cudaStream_t s) {
  // as many bytes as the 16 planes, from J's start, contiguous
  const int64_t n = 16ll * GCY * GCX * sizeof(T) / sizeof(U);
  read_probe_flat<T, U><<<(n / 16 + 255) / 256, 256, 0, s>>>(J, Y, n);
  return (int)cudaGetLastError();
}
template <typename T, typename U>
int probe(const T* J, T* Y, int C, int GCY, int GCX, int lo_r, int lo_c,
          cudaStream_t s) {
  const int64_t plane = (int64_t)GCY * GCX;
  const int64_t n = plane * sizeof(T) / sizeof(U);
  read_probe<T, U><<<(n + 255) / 256, 256, 0, s>>>(J, Y, C, plane, lo_r,
                                                    lo_c, n);
  return (int)cudaGetLastError();
}
"""
PROBES = {"read yardstick: the 16 planes, 16-byte loads": "{v}",
          "read yardstick: the 16 planes, single-value loads": "{t}"}


def _variant_name(dt, name):
    return f"phi_{dt}_" + "".join(c if c.isalnum() else "_" for c in name)


def _nvcc(src, lib):
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return proc.stdout + proc.stderr


def build(parent_dir):
    """The parent's library and this tree's with the variant entry points;
    returns the two CDLLs and prints the ptxas lines of the tree's
    phase-field kernels."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    tree_src = os.path.join(kernels.SRC_DIR, "lattice_stencil.cu")
    lines = [f'#include "{tree_src}"', ""]
    for dt, t, vec in (("f32", "float", 4), ("f64", "double", 2)):
        for name, (threads, load) in VARIANTS.items():
            call = (f"phi2d::launch_path<{t}, {threads}, {load or vec}>"
                    "(J, X, Y, C, GCY, GCX, lo_r, lo_c, s)")
            lines.append(
                f'extern "C" int {_variant_name(dt, name)}'
                f"({ARGS.format(t=t)}) {{\n  (void)R;\n"
                "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
                f"  return {call};\n}}")
    lines.append(PROBE)
    for dt, t, v in (("f32", "float", "float4"), ("f64", "double",
                                                   "double2")):
        lines.append(
            f'extern "C" int probe_flat_{dt}({ARGS.format(t=t)}) {{\n'
            "  (void)R; (void)X; (void)C; (void)lo_r; (void)lo_c;\n"
            f"  return probe_flat<{t}, {v}>(J, Y, GCY, GCX, "
            "static_cast<cudaStream_t>(stream));\n}")
        for i, unit in enumerate(PROBES.values()):
            lines.append(
                f'extern "C" int probe{i}_{dt}({ARGS.format(t=t)}) {{\n'
                "  (void)R; (void)X;\n"
                f"  return probe<{t}, {unit.format(t=t, v=v)}>(J, Y, C, GCY, "
                "GCX, lo_r, lo_c, static_cast<cudaStream_t>(stream));\n}")
    src = os.path.join(kernels.BUILD_DIR, "ab_stencil2d_tree.cu")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    libs = {"parent": os.path.join(kernels.BUILD_DIR, "libab2d_parent.so"),
            "this tree": os.path.join(kernels.BUILD_DIR, "libab2d_tree.so")}
    t0 = time.perf_counter()
    _nvcc(os.path.join(parent_dir, "lattice_stencil.cu"), libs["parent"])
    log = _nvcc(src, libs["this tree"])
    print(f"nvcc (both) {time.perf_counter() - t0:.1f} s")
    entry = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = "phi_kernel" in line and line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            print(f"{entry}: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs["this tree"]],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        if "phi_kernelIfLi64ELi4EE" in name:
            ops = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                part)]
            mem = [o for o in ops if o.split(".")[0] in
                   ("LDG", "LDGSTS", "LDS", "STG", "SHFL", "BAR", "LDGDEPBAR",
                    "DEPBAR", "FFMA")]
            print(f"SASS {name}: {len(ops)} instructions; memory ops and "
                  "FFMAs in "
                  "order: " + " ".join(mem))
    return {side: ctypes.CDLL(path) for side, path in libs.items()}


def _fn(lib, name, n_ints):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bound_us(n, dtype):
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = (16 * n * n + 2 * (n + 1) ** 2) * esz
    return nbytes / HBM_BYTES_PER_S * 1e6, nbytes / 1e6


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(os.path.abspath(sys.argv[1]))
    dev = torch.device("cuda")
    clock = KernelClock(dev)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    for n in LEVELS:
        jac32 = torch.as_tensor(rng.standard_normal((12, 12, n, n),
                                                    dtype=np.float32),
                                device=dev)
        x32 = torch.as_tensor(rng.standard_normal((1, n + 1, n + 1),
                                                  dtype=np.float32),
                              device=dev)
        for dt, dtype in DTYPES.items():
            jac = jac32.to(dtype)
            X = x32.to(dtype)

            def raw(fn, with_k):
                Y = torch.empty_like(X)
                ks = (1, 1) if with_k else ()

                def call():
                    err = fn(jac.data_ptr(), X.data_ptr(), Y.data_ptr(),
                             *jac.shape, LO, LO, *ks, stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    return Y
                return call
            calls = {side: raw(_fn(lib, f"lattice_stencil_{dt}", 8), True)
                     for side, lib in libs.items()}
            ys = {side: call().clone() for side, call in calls.items()}
            torch.cuda.synchronize()
            same = torch.equal(ys["parent"], ys["this tree"])
            bound_us, mb = _bound_us(n, dtype)
            for dirty in (False, True):
                times = {side: [] for side in calls}
                for _ in range(3):
                    for call in calls.values():
                        call()
                for _ in range(ROUNDS):
                    for side in ("parent", "this tree", "this tree",
                                 "parent"):
                        times[side].append(
                            clock.once_ms(calls[side], dirty=dirty) * 1e3)
                med = {side: statistics.median(t) for side, t in
                       times.items()}
                # per round: this tree's mean less the parent's
                diff = [(times["this tree"][2 * r] +
                         times["this tree"][2 * r + 1] -
                         times["parent"][2 * r] -
                         times["parent"][2 * r + 1]) / 2
                        for r in range(ROUNDS)]
                print(f"{dt} phi {n}^2 cells, "
                      f"{'dirty' if dirty else 'clean'}-flush clock: parent "
                      f"{med['parent']:.2f} us (min "
                      f"{min(times['parent']):.2f}, "
                      f"{100 * bound_us / med['parent']:.0f} % of bound), "
                      f"this tree {med['this tree']:.2f} us (min "
                      f"{min(times['this tree']):.2f}, "
                      f"{100 * bound_us / med['this tree']:.0f} % of "
                      f"bound); this tree - parent per round: median "
                      f"{statistics.median(diff):+.2f} us, "
                      f"{sum(d < 0 for d in diff)} of {ROUNDS} rounds "
                      f"faster; bound {bound_us:.1f} us ({mb:.1f} MB); "
                      f"same bits {same}")
            if not same:
                raise AssertionError(f"{dt} phi {n}^2: the two libraries "
                                     "differ")
            if n not in VARIANT_LEVELS:
                continue
            fns = {"entry point": calls["this tree"]}
            for name in VARIANTS:
                fns[name] = raw(_fn(libs["this tree"],
                                    _variant_name(dt, name), 6), False)
                y = fns[name]()
                torch.cuda.synchronize()
                if not torch.equal(y, ys["this tree"]):
                    raise AssertionError(f"{name} {n}^2 differs from the "
                                         "entry point")
            for D in (1, 4):
                mesh = make_shard_mesh([dev] * D)
                JP = stencil.pad_jac_sharded(jac, LO, LO + 4, LO, LO + 4, mesh)
                name = f"sharded kernel, D = {D} (TMA ring)"
                fns[name] = (lambda JP=JP, mesh=mesh:
                             stencil.stencil_matvec_sharded(JP, X, 1, mesh))
                if not torch.equal(fns[name](), ys["this tree"]):
                    raise AssertionError(f"{name} {n}^2 differs from the "
                                         "entry point")
            for i, name in enumerate(PROBES):
                fns[name] = raw(_fn(libs["this tree"], f"probe{i}_{dt}", 6),
                                False)
            fns["read yardstick: as many bytes, contiguous, 16-byte "
                "loads"] = raw(_fn(libs["this tree"], f"probe_flat_{dt}", 6),
                               False)
            fns["empty launch: torch.cuda._sleep(1)"] = (
                lambda: torch.cuda._sleep(1))
            times = {name: [] for name in fns}
            for _ in range(15):
                for name, fn in fns.items():
                    times[name].append(clock.once_ms(fn) * 1e3)
            for name, t in times.items():
                us = statistics.median(t)
                print(f"  {dt} phi {n}^2 {name}: {us:.1f} us (min "
                      f"{min(t):.1f}), {100 * bound_us / us:.0f} % of bound"
                      + ("" if "yardstick" in name or "launch" in name
                         else "; same bits as the entry point"))
        del jac32, x32
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
