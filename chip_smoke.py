"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
without printing the final line:

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and the torch/CUDA versions;
2. build: compiles the four stencil libraries from cracks_tpu_torch/csrc/
   (2d and 3d, unsharded and row-slab sharded; the 2d unsharded library
   holds the one-thread-per-vertex kernel of its k = 2 products and the
   phase-field kernel of lattice_stencil2d_phi.cuh for k = 1, the 3d one
   the one-thread-per-vertex kernel of its f32 entry point and the
   streaming kernel of its f64 entry point) with nvcc, one compiler per
   source, all started together (timed), and prints what ptxas says of
   each (registers, shared memory, spills);
3. kernel vs plain, 2d and 3d: each kernel against its plain PyTorch
   version on the card, at the main paths' shapes (2d: refine-6 Sneddon,
   640x640 cells; 3d: refine-3 Sneddon, 80^3 cells) for the five
   stencil products the solve runs, from seeded numpy inputs.  The
   kernel, the plain version and the library yardstick (the same block
   assembled once as a torch.sparse CSR matrix, times X) are timed with
   cracks_tpu_torch/kernel_clock.py: CUDA events around one call queued
   behind a device-side sleep (the card's time alone, not the host's
   enqueue), median of 25 runs, the L2 flushed before each by reading
   128 MB that nothing writes (no dirty line left to write back inside
   the timed window); the bound is
   the bytes of J + X + Y over 3.35 TB/s or the flops over the card's
   peak rate, whichever is larger.  For the two f32 blocks of the CG
   pass (u and phi), the row-slab sharded product on D = 4 shards
   (ops.stencil.stencil_matvec_sharded: one launch of the sharded kernel
   for all shards, which must be exactly one launch per product) on the
   same inputs must equal the unsharded kernel bit for bit (max
   |difference| 0) and the plain version within TOL; it is timed the
   same way, beside its plain version (the per-shard plain products
   with the halo exchange) and the same CSR call, with a bound that adds
   the halo bytes (the per-shard J halo rows and two X rows per shard)
   to J + X + Y.  The 2d phase-field blocks (f32 and f64) of the
   phase-field kernel and the 3d f64 square blocks (u and phase field)
   of the streaming kernel must equal the sharded kernel at D = 1 bit
   for bit;
4. main paths, small: the port's Simulation on the card and on the CPU
   (plain versions) at 2d refine 3 and 3d refine 1, replicated and with
   dof_sharding = lattice on 4 shards; the energies must agree to rel
   1e-7 with equal Newton iterations per step (the four CPU runs go to
   spawned worker processes at once, while the card runs its side);
5. main path 2d, full size: the Sneddon 2d bench case (refine 6,
   1,232,643 DoFs, two load steps, lattice GMG mixed-precision CG);
6. main path 3d, full size: Sneddon 3d at refine 3 (2,125,764 DoFs, two
   load steps, the same solver settings);
7. the sharded main paths: 5 and 6 again with n_devices = 4,
   dof_sharding = lattice (the lattice-layout Newton, 4 row slabs on the
   one card); bulk and crack energy must agree with the replicated run
   of 5 or 6 to rel 1e-7 with equal Newton iterations per step, and the
   sharded kernel's launches plus the unsharded kernel's launches of the
   sharded run must equal the unsharded kernel's launches of the
   replicated run: every fine-level f32 product went through the
   sharded kernel, once.
   In 5 to 7 every step must converge without a time-step cut, with
   finite statistics and positive bulk energy, and the path's kernels
   must be launched (in 2d the one-thread-per-vertex kernel and the
   phase-field kernel each, in 3d the f32 one-thread-per-vertex kernel
   and the f64 streaming kernel each): their counts are set to 0 just
   before the run and read just after;
8. golden 2d: params/tests/sneddon_2d_1.prm on the card (local
   pre-refinement, hanging nodes, the dense direct solve, one Sneddon
   refinement cycle): its statistics table against
   tests/golden/sneddon_2d_1.statistics under the numdiff rule of
   tests/regression.py (|d| <= 1e-6 or rel <= 1e-8), TCV 0.0418879
   +- 1e-6, phi L2 error 0.978645 +- 1e-5, the cod-04b.txt value at
   x = 0 0.00296695 +- 1e-8, 777 final DoFs;
9. golden 3d, first step: params/tests/sneddon_3d_1.prm with
   max_no_timesteps = 0 (5,324 DoFs, dense direct) against the first
   row of tests/golden/sneddon_3d_1.mpirun=4.statistics (atol 1e-6 or
   rtol 1e-8);
10. the shipped file: params/parameters_sneddon_2d.prm as shipped (four
   mesh epochs, 777 -> 12,993 DoFs, the dense direct solve and then
   the stored-element-matrix Jacobi CG) against the JAX package's table
   tests/torch_reference/parameters_sneddon_2d.statistics (written by
   scripts/torch_reference.py): the same rows and DoFs, every other
   value within rel 1e-7, no time-step cut; per epoch the DoFs, the
   solve taken, Newton and linear iterations per step beside the JAX
   run's (parameters_sneddon_2d.effort.json) and seconds per step;
11. the production run: the shipped file with n_global_pre_refine = 2
   and cg_maxiter = 20000 (last epoch 168,609 DoFs on the assembled f64
   Jacobi CG): no time-step cut, finite statistics, positive bulk
   energy, and the TCV error against the closed form falling from each
   epoch to the next; per epoch the DoFs, the solve, seconds per step,
   Newton and linear iterations, host seconds of refinement + system
   setup and the peak device memory.
   Phases 8-11 run no hand-written kernel (dense LU through
   torch.linalg, the stored-matrix CG through torch ops); the stencil
   kernels' counts are set to 0 before each and printed after it.

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

import concurrent.futures
import gc
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# non-tensor-core peak rates (H100 SXM data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# f32: the bounds of tests/test_pallas_stencil.py; f64: rounding-level
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-12)}
f32, f64 = torch.float32, torch.float64
# per library: its cell grid on the main path and the five products the
# solve runs, (name, dtype, lo_r, hi_r, lo_c, hi_c, k_in, k_out): the u
# block and the phase-field block of the f32 CG pass / V-cycle, and the
# f64 u block, J_pu coupling block and phase-field block of the
# refinement residual.  `route`: the second kernel of the library, the
# products it takes and the wrapper's count of its launches
KERNELS = [
    dict(name="lattice_stencil", dim=2, cells=(640, 640),
         sharded="lattice_stencil_sharded",
         replaces="cracks_tpu/ops/pallas_stencil.py:39",
         replaces_sharded="cracks_tpu/ops/pallas_stencil.py:171",
         shapes=[("f32 u block", f32, 0, 8, 0, 8, 2, 2),
                 ("f32 phi block", f32, 8, 12, 8, 12, 1, 1),
                 ("f64 u block", f64, 0, 8, 0, 8, 2, 2),
                 ("f64 J_pu block", f64, 8, 12, 0, 8, 2, 1),
                 ("f64 phi block", f64, 8, 12, 8, 12, 1, 1)],
         route=dict(name="lattice_stencil2d_phi",
                    source="cracks_tpu_torch/csrc/lattice_stencil2d_phi.cuh",
                    wrapper="cracks_tpu_torch/ops/stencil.py:"
                            "stencil_matvec2d (k_in = k_out = 1)",
                    counter="phi_launches",
                    takes=lambda r: r["k_in"] == r["k_out"] == 1)),
    dict(name="lattice_stencil3d", dim=3, cells=(80, 80, 80),
         sharded="lattice_stencil3d_sharded",
         replaces="cracks_tpu/ops/pallas_stencil.py:232",
         replaces_sharded="cracks_tpu/ops/pallas_stencil.py:368",
         shapes=[("f32 u block", f32, 0, 24, 0, 24, 3, 3),
                 ("f32 phi block", f32, 24, 32, 24, 32, 1, 1),
                 ("f64 u block", f64, 0, 24, 0, 24, 3, 3),
                 ("f64 J_pu block", f64, 24, 32, 0, 24, 3, 1),
                 ("f64 phi block", f64, 24, 32, 24, 32, 1, 1)],
         route=dict(name="lattice_stencil3d_stream",
                    source="cracks_tpu_torch/csrc/"
                           "lattice_stencil3d_stream.cuh",
                    wrapper="cracks_tpu_torch/ops/stencil.py:"
                            "stencil_matvec3d (f64)",
                    counter="f64_launches",
                    takes=lambda r: r["dtype"] == "float64")),
]
# the main paths: small (dim, refine, DoFs) and full size dim -> (refine,
# DoFs)
SMALL = [(2, 3, 19_683), (3, 1, 37_044)]
FULL = {2: (6, 1_232_643), 3: (3, 2_125_764)}
# the sharded runs: D row slabs of the leading grid axis on the one card
D_SHARDS = 4
SHARDED = dict(n_devices=D_SHARDS, dof_sharding="lattice")


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")


def build_phase():
    from cracks_tpu_torch import kernels
    names = [k[key] for k in KERNELS for key in ("name", "sharded")]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(kernels.build, names))
    for name in names:
        getattr(kernels, name)()
    print(f"build: {[path for path, _ in builds]} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (_, log) in zip(names, builds):
        if log.strip():
            print(f"{name}: ptxas\n" + "\n".join(
                line for line in log.strip().splitlines()
                if "ptxas" in line or "spill" in line))


def _csr_block(jac, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """The J block assembled once as a (k_out*nvert, k_in*nvert) CSR
    matrix: rows d*nvert + v, columns e*nvert + w, the layout of Y and
    X flattened."""
    from cracks_tpu_torch.ops.stencil import _corner_offsets
    grid = tuple(c + 1 for c in jac.shape[2:])
    nvert = int(np.prod(grid))
    dev = jac.device
    pos = torch.arange(nvert, device=dev).reshape(grid)
    wins = torch.stack([pos[tuple(slice(o[j], grid[j] - 1 + o[j])
                                  for j in range(len(grid)))].reshape(-1)
                        for o in _corner_offsets(len(grid))])
    rows = (torch.arange(k_out, device=dev)[None, :, None] * nvert
            + wins[:, None, :]).reshape(hi_r - lo_r, 1, -1)
    cols = (torch.arange(k_in, device=dev)[None, :, None] * nvert
            + wins[:, None, :]).reshape(1, hi_c - lo_c, -1)
    shape = (hi_r - lo_r, hi_c - lo_c, wins.shape[1])
    idx = torch.stack([rows.expand(shape).reshape(-1),
                       cols.expand(shape).reshape(-1)])
    del rows, cols, wins, pos
    A = torch.sparse_coo_tensor(idx, jac[lo_r:hi_r, lo_c:hi_c].reshape(-1),
                                (k_out * nvert, k_in * nvert),
                                check_invariants=False)
    del idx
    return A.coalesce().to_sparse_csr()


def sharded_record(spec, name, jac, X, lo, hi, k, y, clock, library_ms):
    """The row-slab sharded product (D_SHARDS shards) of one f32 square
    block on the kernel phase's inputs: one launch, bit for bit against
    the unsharded kernel's Y, within TOL of the plain version, and
    timed; returns its record."""
    from cracks_tpu_torch.ops.stencil import (
        pad_jac_sharded, stencil_matvec_reference, stencil_matvec_sharded,
        stencil_matvec_sharded_reference)
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    mesh = make_shard_mesh(["cuda"] * D_SHARDS)
    JP = pad_jac_sharded(jac, lo, hi, lo, hi, mesh)
    before = stencil_matvec_sharded.launches
    ys = stencil_matvec_sharded(JP, X, k, mesh)
    per_product = stencil_matvec_sharded.launches - before
    torch.cuda.synchronize()
    if per_product != 1:
        raise AssertionError(f"{spec['sharded']} {name}: {per_product} "
                             "launches for one product")
    diff = float((ys - y).abs().max())
    if diff != 0.0 or not torch.equal(ys, y):
        raise AssertionError(f"{spec['name']} sharded {name}: differs from "
                             f"the unsharded kernel, max |diff| {diff:.3e}")
    y_ref = stencil_matvec_reference(jac, X, lo, hi, lo, hi, k, k)
    rtol, atol_rel = TOL[jac.dtype]
    scale = float(y_ref.abs().max())
    err = (ys - y_ref).abs()
    max_abs_err = float(err.max())
    if not bool((err <= atol_rel * scale + rtol * y_ref.abs()).all()):
        raise AssertionError(f"{spec['name']} sharded {name}: disagrees "
                             f"with the plain version, max |err| "
                             f"{max_abs_err:.3e}")
    del err, y_ref, ys
    ms = clock.median_ms(lambda: stencil_matvec_sharded(JP, X, k, mesh))
    plain_ms = clock.median_ms(
        lambda: stencil_matvec_sharded_reference(JP, X, k, mesh))
    esz = jac.element_size()
    cells, grid = jac.shape[2:], X.shape[1:]
    kl = hi - lo
    nbytes = (kl * kl * int(np.prod(cells)) + 2 * k * int(np.prod(grid))
              # one J halo row and two X halo rows per shard
              + D_SHARDS * (kl * kl * int(np.prod(cells[1:]))
                            + 2 * k * int(np.prod(grid[1:])))) * esz
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * kl * kl * int(np.prod(cells)) / PEAK_FLOPS[jac.dtype] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"{spec['sharded']} {name} (D={D_SHARDS} on {mesh.device}, "
          f"carrier {tuple(JP.shape)}): {per_product} launch per product; "
          f"max|sharded - unsharded kernel| {diff:.1e}; max|err| vs plain "
          f"{max_abs_err:.3e}; sharded {ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}, {nbytes / 1e6:.1f} MB), "
          f"{100 * bound_ms / ms:.1f} % of bound; plain "
          f"{plain_ms * 1e3:.1f} us; CSR {library_ms * 1e3:.1f} us")
    del JP
    return dict(name=name, k_in=k, k_out=k, dtype="float32",
                shards=D_SHARDS, launches_per_product=per_product,
                max_abs_diff_unsharded=diff,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                mb=nbytes / 1e6)


def sharded_d1_diff(spec, name, jac, X, lo, hi, k, y):
    """The sharded kernel at D = 1 on one square block of the kernel
    phase's inputs must equal the unsharded kernel's Y bit for bit (the
    same order of terms on the same values); returns max |difference|,
    0.0."""
    from cracks_tpu_torch.ops.stencil import (pad_jac_sharded,
                                              stencil_matvec_sharded)
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    mesh = make_shard_mesh(["cuda"])
    JP = pad_jac_sharded(jac, lo, hi, lo, hi, mesh)
    ys = stencil_matvec_sharded(JP, X, k, mesh)
    torch.cuda.synchronize()
    diff = float((ys - y).abs().max())
    if diff != 0.0 or not torch.equal(ys, y):
        raise AssertionError(f"{spec['name']} {name}: differs from the "
                             f"sharded kernel at D = 1, max |diff| "
                             f"{diff:.3e}")
    print(f"{spec['name']} {name}: max|kernel - sharded kernel at D=1| "
          f"{diff:.1e}")
    del JP, ys
    return diff


def kernel_phase(spec):
    """Kernel vs plain version vs CSR yardstick at one kernel's main-path
    shapes, and the sharded product of the f32 square blocks; returns
    (one record per shape, one sharded record per f32 square block)."""
    from cracks_tpu_torch.kernel_clock import KernelClock
    from cracks_tpu_torch.ops.stencil import (stencil_matvec,
                                              stencil_matvec_reference)
    dev = torch.device("cuda")
    cells, dim = spec["cells"], spec["dim"]
    ndl = 2 ** dim * (dim + 1)
    grid = tuple(c + 1 for c in cells)
    rng = np.random.default_rng(SEED)
    # f32 normals, widened on the card: exact, and half the host work
    jac64 = torch.as_tensor(rng.standard_normal((ndl, ndl) + cells,
                                                dtype=np.float32),
                            device=dev).to(f64)
    x64 = torch.as_tensor(rng.standard_normal((dim,) + grid), dtype=f64,
                          device=dev)
    clock = KernelClock(dev)
    records, sharded = [], []
    for name, dt, lo_r, hi_r, lo_c, hi_c, k_in, k_out in spec["shapes"]:
        jac = jac64.to(dt)
        X = x64[:k_in].to(dt).contiguous()
        args = (lo_r, hi_r, lo_c, hi_c, k_in, k_out)
        y = stencil_matvec(jac, X, *args)
        y_ref = stencil_matvec_reference(jac, X, *args)
        torch.cuda.synchronize()
        rtol, atol_rel = TOL[dt]
        scale = float(y_ref.abs().max())
        err = (y - y_ref).abs()
        max_abs_err = float(err.max())
        ok = bool((err <= atol_rel * scale + rtol * y_ref.abs()).all())
        if not ok or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{spec['name']} {name}: kernel disagrees "
                                 f"with the plain version, max |err| "
                                 f"{max_abs_err:.3e}, max |Y| {scale:.3e}")
        del err, y_ref
        ms = clock.median_ms(lambda: stencil_matvec(jac, X, *args))
        plain_ms = clock.median_ms(
            lambda: stencil_matvec_reference(jac, X, *args))
        A = _csr_block(jac, *args)
        xf = X.reshape(-1)
        csr_err = float((A @ xf - y.reshape(-1)).abs().max())
        library_ms = clock.median_ms(lambda: A @ xf)
        nnz = A.values().numel()
        del A
        nblock = (hi_r - lo_r) * (hi_c - lo_c) * int(np.prod(cells))
        nvert = int(np.prod(grid))
        nbytes = (nblock + (k_in + k_out) * nvert) * jac.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * nblock / PEAK_FLOPS[dt] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"{spec['name']} {name}: k_in={k_in} k_out={k_out} "
              f"max|err|={max_abs_err:.3e} (max|Y| {scale:.3e}, rtol "
              f"{rtol:g}, atol {atol_rel:g}*max|Y|); kernel {ms * 1e3:.1f}"
              f" us, bound {bound_ms * 1e3:.1f} us ({bound_by}, "
              f"{nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} GB/s; "
              f"plain {plain_ms * 1e3:.1f} us; CSR {library_ms * 1e3:.1f} "
              f"us ({nnz} nonzeros, max|CSR - kernel| {csr_err:.3e})")
        records.append(dict(name=name, k_in=k_in, k_out=k_out,
                            dtype=str(dt).replace("torch.", ""),
                            max_abs_err=max_abs_err, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            mb=nbytes / 1e6, gbps=nbytes / ms / 1e6))
        if dt == f32 and (lo_r, k_in) == (lo_c, k_out):
            sharded.append(sharded_record(spec, name, jac, X, lo_r, hi_r,
                                          k_in, y, clock, library_ms))
        if spec["route"]["takes"](records[-1]) and (lo_r, k_in) == (lo_c,
                                                                   k_out):
            records[-1]["max_abs_diff_sharded_d1"] = sharded_d1_diff(
                spec, name, jac, X, lo_r, hi_r, k_in, y)
        del jac, X, y, xf
        torch.cuda.empty_cache()
    del jac64, x64, clock
    torch.cuda.empty_cache()
    return records, sharded


def _params(dim, refine, **overrides):
    from cracks_tpu_torch import config
    return config.load_parameters(
        os.path.join(ROOT, "params", f"parameters_sneddon_{dim}d.prm"),
        n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
        cg_maxiter=3000, dtype="float64", mixed_precision_cg=True,
        **overrides)


def _label(overrides):
    return (f" sharded (D={overrides['n_devices']}, dof_sharding=lattice)"
            if overrides else "")


def _energies(sim):
    d = sim.statistics.data
    return np.array([d["Bulk Energy"], d["Crack Energy"]], dtype=float)


def _run_small(dim, refine, overrides, device, n_threads=None):
    """One small case: (DoFs, energies, (Newton, linear) its per step,
    seconds).  On the CPU it runs in a worker process of small_phases,
    with n_threads threads."""
    from cracks_tpu_torch.driver import Simulation
    if n_threads:
        torch.set_num_threads(n_threads)
    t0 = time.perf_counter()
    sim = Simulation(_params(dim, refine, **overrides), device=device,
                     verbose=False)
    sim.run()
    return (sim.mesh.n_dofs, _energies(sim),
            [(e[1], e[2]) for e in sim.solver_effort],
            time.perf_counter() - t0)


def small_phases():
    """Each small case, replicated and sharded, on the card vs the plain
    versions on the CPU.  The CPU runs (the 3d ones take minutes of
    plain einsums) go to spawned worker processes at once, splitting the
    host's cores, while the card runs its side; nothing here is
    timed."""
    jobs = [(dim, refine, n_dofs, ov) for dim, refine, n_dofs in SMALL
            for ov in ({}, SHARDED)]
    # the two 3d runs take minutes, the two 2d runs seconds: the 3d ones
    # get the cores the 2d ones leave
    threads = {2: 1, 3: max(1, ((os.cpu_count() or 4) - 2) // 2)}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(jobs),
                                                mp_context=ctx) as pool:
        cpu = [pool.submit(_run_small, dim, refine, ov, "cpu", threads[dim])
               for dim, refine, _, ov in jobs]
        for (dim, refine, n_dofs, ov), fut in zip(jobs, cpu):
            runs = {"cuda": _run_small(dim, refine, ov, "cuda")}
            runs["cpu"] = fut.result()
            name = f"{dim}d refine {refine}{_label(ov)}"
            for dev, (dofs, energies, its, secs) in runs.items():
                print(f"{name} on {dev} ({dofs} DoFs, {secs:.1f} s"
                      f"{f', {threads[dim]} threads' if dev == 'cpu' else ''}"
                      "):"
                      f" Newton/linear its per step {its}, energies "
                      f"{energies.tolist()}")
                if dofs != n_dofs:
                    raise AssertionError(f"{dofs} DoFs, expected {n_dofs}")
            a, b = runs["cuda"][1], runs["cpu"][1]
            rel = float(np.max(np.abs(a - b) / np.abs(b)))
            print(f"{name} cuda vs cpu: max relative energy difference "
                  f"{rel:.3e} (bound 1e-7)")
            if not rel <= 1e-7:
                raise AssertionError(f"card and CPU runs disagree: {name}")
            newton = [[n for n, _ in runs[d][2]] for d in ("cuda", "cpu")]
            if newton[0] != newton[1]:
                raise AssertionError(f"Newton iterations per step differ "
                                     f"between card and CPU: {newton}")


def main_phase(dim, refine=None, n_dofs=None, replicated=None,
               **overrides):
    """One full-size main path on the card.  Returns the energies,
    Newton iterations per step and the launch counts of the path's
    unsharded kernels (in all, and of the library's second kernel,
    `route`) and of the sharded kernel.  With `replicated` (that return of
    the same case without sharding) the energies must agree to rel 1e-7
    with equal Newton iterations, and the sharded run's sharded plus
    unsharded launches must equal the replicated run's unsharded
    launches: one sharded launch for every fine-level f32 product."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import stencil
    if refine is None:
        refine, n_dofs = FULL[dim]
    label = f"{dim}d{_label(overrides)} main path"
    kernel = stencil.stencil_matvec2d if dim == 2 else stencil.stencil_matvec3d
    route = next(k["route"] for k in KERNELS if k["dim"] == dim)
    t0 = time.perf_counter()
    sim = Simulation(_params(dim, refine, **overrides), device="cuda",
                     verbose=True)
    host_s = time.perf_counter() - t0
    if sim.mesh.n_dofs != n_dofs:
        raise AssertionError(f"{sim.mesh.n_dofs} DoFs, expected {n_dofs}")
    torch.cuda.reset_peak_memory_stats()
    stencil.stencil_matvec2d.launches = 0
    stencil.stencil_matvec2d.phi_launches = 0
    stencil.stencil_matvec3d.launches = 0
    stencil.stencil_matvec3d.f64_launches = 0
    stencil.stencil_matvec_sharded.launches = 0
    sim.run()
    launches = kernel.launches
    route_launches = getattr(kernel, route["counter"])
    sharded = stencil.stencil_matvec_sharded.launches
    torch.cuda.synchronize()
    steps = len(sim.solver_effort)
    if steps != 2 or sim.step_cuts:
        raise AssertionError(f"{steps} steps, {sim.step_cuts} time-step "
                             "cuts: a load step did not converge")
    values = [v for col in sim.statistics.data.values() for v in col
              if isinstance(v, float)]
    if not all(np.isfinite(values)):
        raise AssertionError(f"non-finite statistics: "
                             f"{sim.statistics.data}")
    if not min(sim.statistics.data["Bulk Energy"]) > 0:
        raise AssertionError("bulk energy is not positive")
    if launches <= 0:
        raise AssertionError(f"the {label} never launched its kernel")
    if not 0 < route_launches < launches:
        raise AssertionError(f"the {label} launched {route['name']} "
                             f"{route_launches} times in {launches} "
                             f"{dim}d launches")
    out = dict(energies=_energies(sim), launches=launches, sharded=sharded,
               route_launches=route_launches,
               newton=[e[1] for e in sim.solver_effort])
    print(f"{label}: host setup (forest, mesh) {host_s:.2f} s, "
          f"setup system {sim.timer.wall['Setup system']:.2f} s")
    for (step, newton_its, lin_its, n_active), (_, _, secs) in zip(
            sim.solver_effort, sim.step_times):
        print(f"{label} step {step}: {secs:.2f} s, {newton_its} Newton its,"
              f" {lin_its} linear its, active set {n_active}")
    print(f"{label}: {sim.mesh.n_dofs} DoFs, kernel launches {launches} "
          f"({route_launches} of {route['name']}), sharded-kernel launches "
          f"{sharded}, peak "
          f"device memory {torch.cuda.max_memory_allocated()} B, energies "
          f"{[repr(float(e)) for e in out['energies'].ravel()]}")
    if replicated is not None:
        mesh = sim.sys.shard_mesh
        print(f"{label}: {mesh.n_shards} shards of the "
              f"{sim.sys.lattice_hierarchy.grid[0]}-row leading axis "
              f"(padded to {sim.sys.lat_gyp}) on {mesh.device} "
              f"({torch.cuda.get_device_name(mesh.device)})")
        rel = float(np.max(np.abs(out["energies"] - replicated["energies"])
                           / np.abs(replicated["energies"])))
        print(f"{label} vs replicated: max relative energy difference "
              f"{rel:.3e} (bound 1e-7), Newton its {out['newton']} vs "
              f"{replicated['newton']}")
        if not rel <= 1e-7 or out["newton"] != replicated["newton"]:
            raise AssertionError(f"the {label} disagrees with the "
                                 "replicated run")
        print(f"{label}: {sharded} sharded + {launches} unsharded launches"
              f" vs {replicated['launches']} unsharded launches replicated")
        if sharded <= 0 or sharded + launches != replicated["launches"]:
            raise AssertionError(
                f"the {label} launched {sharded} sharded and {launches} "
                f"unsharded kernels; the replicated run "
                f"{replicated['launches']} unsharded")
    del sim
    torch.cuda.empty_cache()
    return out


GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
REFERENCE_DIR = os.path.join(ROOT, "tests", "torch_reference")
PRM_TESTS = os.path.join(ROOT, "params", "tests")
SHIPPED_PRM = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
# the production run: 4x finer than the shipped file; Jacobi CG needs
# about 1/h_min times more iterations, so the cap grows with it
PRODUCTION = dict(n_global_pre_refine=2, cg_maxiter=20000)


def parse_statistics(text):
    """A statistics table as (column names, rows of floats; "" -> nan):
    the reader of tests/regression.py."""
    names, rows = [], []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            names.append(line.split(":", 1)[1].strip())
        else:
            rows.append([float(x) if x != '""' else np.nan
                         for x in line.split()])
    return names, np.array(rows)


def table_failures(ours, ref, atol, rtol):
    """The numdiff rule of tests/regression.py: a value passes if
    |d| <= atol or its relative difference is <= rtol; two empty cells
    pass.  Returns the failing cells."""
    if ours.shape != ref.shape:
        return [f"shape {ours.shape} != {ref.shape}"]
    fails = []
    for (i, j), g in np.ndenumerate(ref):
        o = ours[i, j]
        if np.isnan(g) and np.isnan(o):
            continue
        d = abs(g - o)
        if not (d <= atol or d / max(abs(g), abs(o), 1e-300) <= rtol):
            fails.append(f"row {i} col {j}: {o!r} vs {g!r}")
    return fails


def _zero_stencil_counts():
    from cracks_tpu_torch.ops import stencil
    for fn, counters in ((stencil.stencil_matvec2d,
                          ("launches", "phi_launches")),
                         (stencil.stencil_matvec3d,
                          ("launches", "f64_launches")),
                         (stencil.stencil_matvec_sharded, ("launches",))):
        for c in counters:
            setattr(fn, c, 0)


def _stencil_counts():
    from cracks_tpu_torch.ops import stencil
    return (stencil.stencil_matvec2d.launches,
            stencil.stencil_matvec3d.launches,
            stencil.stencil_matvec_sharded.launches)


def _run_quiet(prm, **overrides):
    """A .prm run on the card with the Newton trace off."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    sim = Simulation(config.load_parameters(prm, **overrides), device="cuda",
                     verbose=False)
    sim.run()
    return sim


def golden2d_phase():
    t0 = time.perf_counter()
    _zero_stencil_counts()
    with tempfile.TemporaryDirectory() as out:
        sim = _run_quiet(os.path.join(PRM_TESTS, "sneddon_2d_1.prm"),
                         output_dir=out)
        with open(os.path.join(out, "statistics")) as f:
            names, ours = parse_statistics(f.read())
        sweep = np.loadtxt(os.path.join(out, "cod-04b.txt"))
    with open(os.path.join(GOLDEN_DIR, "sneddon_2d_1.statistics")) as f:
        g_names, golden = parse_statistics(f.read())
    if names[:len(g_names)] != g_names:
        raise AssertionError(f"columns {names} vs golden {g_names}")
    fails = table_failures(ours[:, :len(g_names)], golden, 1e-6, 1e-8)
    data = sim.statistics.data
    tcv, l2 = data["TCV"][-1], data["phi_L2_error"][-1]
    cod0 = sweep[np.isclose(sweep[:, 0], 0.0), 1]
    print(f"golden 2d (sneddon_2d_1) on cuda: {time.perf_counter() - t0:.2f}"
          f" s, {len(golden)} rows, DoFs {data['DoFs']} -> "
          f"{sim.mesh.n_dofs}, Newton/linear its per step "
          f"{[(e[1], e[2]) for e in sim.solver_effort]}, TCV {tcv!r}, "
          f"phi L2 error {l2!r}, COD(0) {cod0.tolist()}, stencil launches "
          f"{_stencil_counts()}, {len(fails)} cells off the golden")
    if fails:
        raise AssertionError("golden 2d:\n" + "\n".join(fails))
    if not (abs(tcv - 0.0418879) <= 1e-6 and abs(l2 - 0.978645) <= 1e-5
            and len(cod0) == 1 and abs(cod0[0] - 0.00296695) <= 1e-8
            and sim.mesh.n_dofs == 777 and sim.step_cuts == 0):
        raise AssertionError("golden 2d: TCV, phi L2 error, COD(0) or the "
                             "final DoFs off their pins")


def golden3d_phase():
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = _run_quiet(os.path.join(PRM_TESTS, "sneddon_3d_1.prm"),
                     max_no_timesteps=0, output_dir="")
    ours = parse_statistics(sim.statistics.write_text())[1][:1]
    with open(os.path.join(GOLDEN_DIR,
                           "sneddon_3d_1.mpirun=4.statistics")) as f:
        golden = parse_statistics(f.read())[1][:1]
    fails = table_failures(ours, golden, 1e-6, 1e-8)
    print(f"golden 3d first step (sneddon_3d_1) on cuda: "
          f"{time.perf_counter() - t0:.2f} s, {sim.mesh.n_dofs} DoFs, "
          f"Newton/linear its {[(e[1], e[2]) for e in sim.solver_effort]},"
          f" row {ours[0].tolist()} vs golden {golden[0].tolist()}, "
          f"stencil launches {_stencil_counts()}")
    if fails or sim.mesh.n_dofs != 5324 or sim.step_cuts:
        raise AssertionError("golden 3d first step: " + "; ".join(fails))


def _fresh_memory_baseline():
    """Collect what earlier phases left to Python's cycle collector (the
    first torch.func.jvp of a process keeps its callers' frames in a
    cycle), reset the peak counter and return the bytes still
    allocated: the baseline under this phase's per-epoch peaks."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _instrument_epochs(sim):
    """Wrap sim.refine_mesh to record, per call: the DoFs after it, its
    host seconds (refinement + system setup), the solve the new mesh
    takes and the device-memory peak of the epoch it ended."""
    from cracks_tpu_torch.solvers import newton
    records = []
    refine = sim.refine_mesh

    def timed(state):
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        changed = refine(state)
        torch.cuda.synchronize()
        records.append(dict(dofs=sim.mesh.n_dofs,
                            host_s=time.perf_counter() - t0,
                            solve=newton.check_linear_solver(sim.sys),
                            peak_before=peak))
        return changed

    sim.refine_mesh = timed
    return records


def _epochs(sim, records, label, reference=None):
    """Print and return one summary per mesh epoch of a finished run."""
    steps = [(e[0], n, s, e[1], e[2]) for e, (_, n, s) in
             zip(sim.solver_effort, sim.step_times)]
    peaks = [r["peak_before"] for r in records[1:]] + [
        torch.cuda.max_memory_allocated()]
    epochs = []
    for dofs in dict.fromkeys(n for _, n, _, _, _ in steps):
        mine = [s for s in steps if s[1] == dofs]
        k = max(i for i, r in enumerate(records) if r["dofs"] == dofs)
        timed = [s[2] for s in mine if s[0] != 0]   # the first step apart
        ep = dict(dofs=dofs, solve=records[k]["solve"],
                  host_setup_s=records[k]["host_s"], peak_bytes=peaks[k],
                  step_s=[s[2] for s in mine],
                  its=[(s[3], s[4]) for s in mine],
                  s_per_step=(sum(timed) / len(timed) if timed
                              else float("nan")))
        epochs.append(ep)
        ref = ""
        if reference is not None:
            ref = (f" (JAX run: "
                   f"{[(r['newton'], r['linear']) for r in reference if r['dofs'] == dofs]})")
        print(f"{label} epoch {len(epochs)}: {dofs} DoFs, solve "
              f"{ep['solve']}, refinement + setup {ep['host_setup_s']:.3f}"
              f" s, s/step {[round(x, 3) for x in ep['step_s']]} "
              f"(mean without the run's first step "
              f"{ep['s_per_step']:.3f}), Newton/linear its per step "
              f"{ep['its']}{ref}, peak device memory {ep['peak_bytes']} B")
    return epochs


def shipped_phase():
    """The shipped Sneddon 2d file against the JAX package's table."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    with open(os.path.join(REFERENCE_DIR,
                           "parameters_sneddon_2d.effort.json")) as f:
        effort = json.load(f)
    with open(os.path.join(REFERENCE_DIR,
                           "parameters_sneddon_2d.statistics")) as f:
        ref_names, ref = parse_statistics(f.read())
    t0 = time.perf_counter()
    _zero_stencil_counts()
    with tempfile.TemporaryDirectory() as out:
        sim = Simulation(config.load_parameters(SHIPPED_PRM, output_dir=out),
                         device="cuda", verbose=False)
        records = _instrument_epochs(sim)
        base = _fresh_memory_baseline()
        sim.run()
        with open(os.path.join(out, "statistics")) as f:
            names, ours = parse_statistics(f.read())
    secs = time.perf_counter() - t0
    _epochs(sim, records, "shipped", effort)
    dofs_col = ref_names.index("DoFs")
    fails = table_failures(ours, ref, 0.0, 1e-7)
    print(f"shipped file on cuda: {secs:.2f} s, {len(ours)} rows vs "
          f"{len(ref)}, {sim.step_cuts} time-step cuts, device memory "
          f"allocated at its start {base} B, stencil launches "
          f"{_stencil_counts()}, {len(fails)} cells off the JAX table "
          f"(rel 1e-7)")
    if (names != ref_names or ours.shape != ref.shape
            or not np.array_equal(ours[:, dofs_col], ref[:, dofs_col])
            or fails or sim.step_cuts):
        raise AssertionError("shipped file vs the JAX table:\n"
                             + "\n".join(fails[:20]))


def production_phase():
    """The shipped file four times finer (last epoch 168,609 DoFs)."""
    from cracks_tpu_torch import config, qoi
    from cracks_tpu_torch.driver import Simulation
    t0 = time.perf_counter()
    _zero_stencil_counts()
    p = config.load_parameters(SHIPPED_PRM, output_dir="", **PRODUCTION)
    sim = Simulation(p, device="cuda", verbose=False)
    records = _instrument_epochs(sim)
    base = _fresh_memory_baseline()
    sim.run()
    secs = time.perf_counter() - t0
    epochs = _epochs(sim, records, "production")
    data = sim.statistics.data
    tcv = [v for v in data["TCV"] if v != ""]
    exact = qoi.tcv_exact(2, p.pressure(time=1.0), p.poisson_ratio_nu)
    errors = [abs(v - exact) for v in tcv]
    values = [v for col in data.values() for v in col
              if isinstance(v, float)]
    print(f"production (n_global_pre_refine=2, cg_maxiter=20000) on cuda: "
          f"{secs:.2f} s, DoFs per epoch {[e['dofs'] for e in epochs]}, "
          f"bulk energy {data['Bulk Energy']!r}, crack energy "
          f"{data['Crack Energy']!r}, "
          f"{sim.step_cuts} time-step cuts, device memory allocated at its "
          f"start {base} B, TCV per epoch {tcv} (exact "
          f"{exact!r}), errors {errors}, stencil launches "
          f"{_stencil_counts()}")
    if sim.step_cuts or not all(math.isfinite(v) for v in values):
        raise AssertionError("production run: a time-step cut or a "
                             "non-finite statistic")
    if not min(data["Bulk Energy"]) > 0:
        raise AssertionError("production run: bulk energy not positive")
    if len(tcv) != len(epochs) or not all(
            b < a for a, b in zip(errors, errors[1:])):
        raise AssertionError("production run: the TCV error does not fall "
                             "from epoch to epoch")


def main():
    t_start = time.perf_counter()
    device_phase()
    build_phase()
    records = {k["name"]: kernel_phase(k) for k in KERNELS}
    small_phases()
    full = {k["dim"]: main_phase(k["dim"]) for k in KERNELS}
    full_sharded = {dim: main_phase(dim, replicated=full[dim], **SHARDED)
                    for dim in full}
    golden2d_phase()
    golden3d_phase()
    shipped_phase()
    production_phase()
    entries = []
    for k in KERNELS:
        shapes = records[k["name"]][0]
        run = full[k["dim"]]
        # the library's second kernel: the 2d phase-field products (head:
        # the f32 phi block of the CG pass), the 3d f64 products (head:
        # the f64 u block)
        route = k["route"]
        taken = [r for r in shapes if route["takes"](r)]
        shapes = [r for r in shapes if not route["takes"](r)]
        head = taken[0]
        entries.append({
            "name": route["name"], "route": "cuda",
            "source": route["source"], "wrapper": route["wrapper"],
            "replaces": k["replaces"], "launches": run["route_launches"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shapes": taken})
        head = shapes[0]   # the f32 u block: the main product
        entries.append({
            "name": k["name"], "route": "cuda",
            "source": f"cracks_tpu_torch/csrc/{k['name']}.cu",
            "replaces": k["replaces"],
            "launches": run["launches"] - run["route_launches"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": shapes})
        head = records[k["name"]][1][0]   # the sharded f32 u block
        entries.append({
            "name": k["sharded"], "route": "cuda",
            "source": f"cracks_tpu_torch/csrc/{k['sharded']}.cu",
            "wrapper": "cracks_tpu_torch/ops/stencil.py:"
                       "stencil_matvec_sharded",
            "replaces": k["replaces_sharded"],
            "launches": full_sharded[k["dim"]]["sharded"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": records[k["name"]][1]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
