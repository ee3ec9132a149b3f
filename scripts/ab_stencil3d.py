"""The 3d stencil library of two source trees on one CUDA card, side by
side: the compiled f32 kernels compared instruction by instruction, and
every product the 3d solve runs timed in turns.

    git archive <commit> cracks_tpu_torch/csrc | tar -x -C <dir>
    python3 scripts/ab_stencil3d.py <dir>/cracks_tpu_torch/csrc

Builds ``lattice_stencil3d.cu`` of the given source directory (the
parent, say) and of this tree's ``cracks_tpu_torch/csrc`` with the
port's nvcc flags into two libraries, prints whether each f32 kernel's
SASS (``cuobjdump -sass``) is the same in both, and for the five
products at 80^3 cells (f32 u and phi blocks, f64 u, J_pu and phi
blocks) checks that the two libraries give the same bits and times them
in the order parent, this tree, this tree, parent, repeated 10 times on
``cracks_tpu_torch/kernel_clock.py``'s clock (CUDA events around one
launch queued behind a device-side sleep, the L2 flushed before each by
reading 128 MB that nothing writes), as ``chip_smoke.py`` times.
Prints the card's name and power limit first and the median of each
side.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cracks_tpu_torch import kernels  # noqa: E402
from cracks_tpu_torch.kernel_clock import KernelClock  # noqa: E402

CELLS = (80, 80, 80)
# (name, dtype, lo_r, lo_c, k_in, k_out)
PRODUCTS = [("f32 u block", torch.float32, 0, 0, 3, 3),
            ("f32 phi block", torch.float32, 24, 24, 1, 1),
            ("f64 u block", torch.float64, 0, 0, 3, 3),
            ("f64 J_pu block", torch.float64, 24, 0, 3, 1),
            ("f64 phi block", torch.float64, 24, 24, 1, 1)]


def build(src_dir, tag):
    """lattice_stencil3d.cu of src_dir into build/libab_<tag>.so; returns
    (library path, {f32 kernel name: SASS text})."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib = os.path.join(kernels.BUILD_DIR, f"libab_{tag}.so")
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "lattice_stencil3d.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        # the anonymous namespace's hash differs between two files
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N_",
                      part.splitlines()[0].strip())
        if "lattice_stencil3d_kernel" in name and "IfLi" in name:
            # the instructions only: drop addresses and encodings
            body = [re.sub(r"/\*[0-9a-f]{4,5}\*/", "", line).split(";")[0]
                    for line in part.splitlines()[1:]
                    if re.search(r"/\*[0-9a-f]{4,5}\*/", line)]
            funcs[name] = "\n".join(body)
    return lib, funcs


def entry(lib, dtype):
    fn = getattr(lib, "lattice_stencil3d_f32" if dtype == torch.float32
                 else "lattice_stencil3d_f64")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    other = os.path.abspath(sys.argv[1])
    (lib_a, sass_a), (lib_b, sass_b) = (build(other, "parent"),
                                        build(kernels.SRC_DIR, "tree"))
    for name in sorted(set(sass_a) | set(sass_b)):
        same = sass_a.get(name) == sass_b.get(name)
        print(f"SASS {name}: {'identical' if same else 'differs'} "
              f"({len(sass_a.get(name, '').splitlines())} / "
              f"{len(sass_b.get(name, '').splitlines())} instructions)")
    libs = {"parent": ctypes.CDLL(lib_a), "this tree": ctypes.CDLL(lib_b)}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    grid = tuple(c + 1 for c in CELLS)
    jac64 = torch.as_tensor(rng.standard_normal((32, 32) + CELLS,
                                                dtype=np.float32),
                            device=dev).to(torch.float64)
    x64 = torch.as_tensor(rng.standard_normal((3,) + grid), device=dev)
    clock = KernelClock(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name, dtype, lo_r, lo_c, k_in, k_out in PRODUCTS:
        jac = jac64.to(dtype)
        X = x64[:k_in].to(dtype).contiguous()
        ys = {}
        calls = {}
        for side, lib in libs.items():
            fn = entry(lib, dtype)
            Y = torch.empty((k_out,) + grid, dtype=dtype, device=dev)

            def call(fn=fn, Y=Y):
                err = fn(jac.data_ptr(), X.data_ptr(), Y.data_ptr(),
                         *jac.shape, lo_r, lo_c, k_in, k_out, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return Y
            calls[side] = call
            ys[side] = call().clone()
        torch.cuda.synchronize()
        same = torch.equal(ys["parent"], ys["this tree"])
        times = {side: [] for side in calls}
        for _ in range(3):
            for call in calls.values():
                call()
        for _ in range(10):
            for side in ("parent", "this tree", "this tree", "parent"):
                times[side].append(clock.once_ms(calls[side]) * 1e3)
        print(f"{name}: parent {statistics.median(times['parent']):.1f} us"
              f" (min {min(times['parent']):.1f}), this tree "
              f"{statistics.median(times['this tree']):.1f} us (min "
              f"{min(times['this tree']):.1f}); same bits {same}")
        del jac, X, ys, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
