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
   (plain versions) at 2d refine 3 (two load steps) and 3d refine 1
   (load step 0), replicated and with
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
9. golden 3d: params/tests/sneddon_3d_1.prm as shipped (5,324 DoFs,
   dense direct, 4 steps to stationarity) against every row of
   tests/golden/sneddon_3d_1.mpirun=4.statistics (atol 1e-6 or rtol
   1e-8) and the TCV pin of the JAX package's full test (0.0399535 +-
   1e-5);
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
12. the goldens of the other test cases, in full: params/tests/
   miehe_shear_1.prm (the split, the predictor-corrector loop, 891 ->
   1,506 DoFs), miehe_shear_2.prm (a fixed mesh, 25 steps),
   miehe_tension_adaptive_1.prm (33 steps, K reg = 0) and
   threepoint_1.prm (the gmsh mesh, 975 -> 1,347 DoFs), each against its
   table in tests/golden/ under the tolerances of the JAX package's full
   tests (tests/test_regression_miehe.py, test_regression_adaptive.py,
   test_regression_threepoint.py: the numdiff rule with their
   phase-aware column overrides) and with an equal DoF column; each
   prints its time, time-step cuts, redone steps and Newton iterations
   per solve;
13. the shipped Miehe shear file: params/parameters_miehe_shear_adaptive
   .prm as shipped but cut to its first 100 of 200 steps (the load peak
   is at step 97; the split, one adaptive cycle under the
   level cap, 3,315 DoFs until the crack grows) against the JAX
   package's table of its first 100 steps (tests/torch_reference/
   parameters_miehe_shear_adaptive.statistics, written by
   scripts/torch_reference.py) to rel 1e-7 with equal DoFs, then finite
   statistics, positive bulk energy, at least one redone step and a
   "Load x" that peaks and then falls; per epoch the DoFs, the solve,
   seconds per step, Newton and linear iterations, host seconds of
   refinement + system setup and the peak device memory.  Then the
   shipped Miehe tension file, params/parameters_miehe_tension_adaptive
   .prm as shipped (two adaptive cycles, K reg = 0) but cut to its
   first 71 of 89 steps, against the JAX package's table of its first
   86 steps (tests/torch_reference/
   parameters_miehe_tension_adaptive.statistics): every row up to the
   table's load peak (step 64) to rel 1e-7 with equal DoFs, then finite
   statistics, positive bulk energy and a "Load y" that peaks and then
   falls, with the same per-epoch lines.
14. the hetero goldens: params/tests/hetero_3d_1.prm (3d, the bitmap
   material of test.pgm, one local pre-refinement, 5,288 DoFs) as
   shipped against tests/golden/hetero_3d_1.mpirun-4.statistics (the
   JAX package's full-test tolerances: Energy columns |d| <= 1e-6 or
   rel <= 3e-3) with an equal DoF column; with cg + gmg (the f64
   Galerkin block CG, first step) against the golden's first row at
   the same tolerances, at most 60 linear iterations per Newton
   iteration, twice, bit-equal; with mixed precision (the Galerkin
   split solve) within rel 1e-6 of the CPU port (a spawned worker
   process) with equal Newton counts;
15. the full-width hetero-3d run: params/parameters_hetero_3d.prm with
   bench.py's hetero_3d overrides (global refinement 5 + local 5, cg +
   gmg + mixed precision, cg_rtol 1e-8, cg_maxiter 3000, load step 0 of
   bench.py's 3):
   no time-step cut, finite statistics, positive bulk energy, at most
   60 linear iterations per Newton iteration; it prints the DoFs, s,
   Newton and linear iterations per step, the seconds of the f32
   element build, the level operators (RAP chain, diagonals, spectra),
   the f32 CG passes and the f64 refinement passes (each timed between
   synchronizations), the peak device memory and the device's idle
   share during one solve (torch.profiler: summed kernel time against
   the solve's wall time);
16. the production run of phase 11 under preconditioner = gmg (the
   Galerkin hierarchy on every epoch above the dense cap), with and
   without mixed precision, its first 2 of 4 epochs (to 16,953 DoFs):
   per epoch the DoFs, s/step, linear
   iterations per step and TCV beside phase 11's Jacobi numbers; the
   TCV within rel 1e-6 of phase 11's in every epoch and its error
   falling from epoch to epoch.
   Phases 8-16 run no hand-written kernel (dense LU through
   torch.linalg, the stored-matrix CG and the Galerkin GMG through
   torch ops); the stencil kernels' counts are set to 0 before each and
   printed after it.
17. the seam lattice (the uniformly refined slit mesh of the Miehe
   cases under the lattice GMG) and the penalized monolithic Newton.
   Small: params/tests/miehe_shear_2.prm at refinement 3 and 5 (891 and
   12,771 DoFs) under bench.py's solver settings, 3 steps, on the card
   against the CPU port (spawned workers) and with n_devices = 4,
   dof_sharding = lattice against the replicated card run, and the
   simple monolithic solver on sneddon_2d_1.prm at refinement 0 (the
   dense solve) and 1 (the lattice solve) on the card against the CPU
   port: statistics within rel 1e-7 (the lattice run's crack energy,
   ~6e-10 and set by the Newton's stopping point, within 1e-6) with
   equal Newton iterations per step, the 2d kernels launched on the
   lattice.  The seam product (collect . kernel . spread) of the 2d
   kernel's five products at the refine-8 shapes against the same
   conjugation of the plain version (TOL), its mirror slots zero, the
   sharded one (f32 blocks, D = 4) bit for bit against the unsharded,
   each timed beside the bare kernel.  Full width: bench.py's
   miehe_shear case (refinement 8, 790,275 DoFs, the 7-level (514, 513)
   seam lattice, cg + gmg + mixed precision, cg_rtol 1e-8,
   MIEHE_FULL_STEPS load steps): no time-step cut, finite statistics,
   positive bulk energy, the 2d kernel and the phase-field kernel
   launched (counts set to 0 before the run, read after); it prints
   s/step, Newton and linear iterations per step, the peak device
   memory and the device's idle share during one solve
   (torch.profiler); then its first 3 steps with n_devices = 4,
   dof_sharding = lattice, within rel 1e-7 of the replicated run with
   equal Newton iterations and the sharded kernel launched.

18. the matrix-free operator (assembled_matvec = False: every Krylov
   iteration one jvp of the element residual, the iterations replayed
   from CUDA graphs; no stencil kernel, its counts set to 0 before each
   run and checked after).  Small, card against the CPU port (spawned
   workers, compared after the full-size runs): Sneddon 2d refine 3
   (19,683 DoFs, two steps) under the Jacobi CG in f64 and with mixed
   precision, Sneddon 3d refine 1 (37,044 DoFs, load step 0) with mixed
   precision,
   the geometric GMG on miehe_tension_adaptive_1's step 0 (three
   levels; on the CPU the Sneddon file's thousands of V-cycles per step
   do not fit) and miehe_shear_1 under the simple monolithic solver, 3
   steps: statistics within rel 1e-7, equal Newton iterations per step,
   linear iterations within 5 % per step.  The round-1 configuration:
   Sneddon 2d at refine 4 (77,763 DoFs, two steps, cg_maxiter 3000)
   under the Jacobi CG in f64 and with mixed precision, each on the
   JAX package's table (tests/torch_reference/
   sneddon_2d_matrix_free_r4.statistics) to rel 1e-7 and the verify
   skill's step-0 oracle to rel 1e-6, one solve profiled (idle share,
   launches per CG iteration); and the geometric GMG at refine 3 (at
   refine 4 it takes over 120 s), load step 0, its bulk energy within
   rel 1e-7 of the small f64 Jacobi run's.  Each prints per step the
   Newton and linear iterations and seconds, and the peak memory; no
   time-step cut, finite statistics, positive bulk energy.
19. the multi-shard modes, D shards on the one card (no new kernel; the
   halo pool computes with gathers, einsums and ordered scatters on the
   stored element matrices).  Small, card against the CPU port (spawned
   workers): the mesh of __graft_entry__.dryrun_multichip's halo step
   (sneddon_2d_1.prm, one local pre-refinement at phase-field value
   0.5: 453 DoFs, 12 hanging vertices, two load steps, the Jacobi CG)
   at n_devices = 4 and 8, dof_sharding = lattice (the owned+ghost halo
   pool), and hetero_3d_1 as shipped (5,288 DoFs) at n_devices = 4
   under tests/test_halo_newton.py's settings (cg + gmg, cg_rtol 1e-10,
   mixed precision; the pool takes its Jacobi CG all the same):
   statistics within rel 1e-7, equal Newton iterations per step; the
   hetero run also within the JAX np1/np8 tolerance (abs 1e-6 or rel
   1e-7) of the replicated card run.  On the card alone: the halo run
   with assembled_matvec = False bit-equal to the D = 4 one; the
   replicated mode at n_devices = 4 (Sneddon 2d refine 3) bit-equal to
   n_devices = 1; mesh_dcn = 2 at n_devices = 4, dof_sharding =
   lattice bit-equal to the flat D = 4 lattice run, the sharded kernel
   launched; the monolithic solver with dof_sharding = lattice (the
   replicated fallback) bit-equal to n_devices = 1.  Full width: phase
   11's production run at n_devices = 4, dof_sharding = lattice, the
   halo pool on every epoch: no time-step cut, finite statistics,
   positive bulk energy, phase 11's DoFs per epoch, the TCV within rel
   1e-6 of phase 11's in every epoch in which no block CG reached its
   2000-iteration cap (such an epoch is printed, not exempt from the
   rest), its error falling; per epoch the DoFs, pool size B and slots
   per shard, s/step, Newton and linear iterations per step, the
   largest block-CG count and the peak device memory, and the device's
   idle share during one solve of the last epoch (torch.profiler).
20. the halo pool on W ranks of the one card (torch.distributed; the
   ranks share the card, so gloo with CUDA tensors staged through
   pinned host memory; `parallel.dist.launch`), held to phase 19's card
   runs: its small halo cases at W = 2 and 4 (the dryrun mesh at D = 4
   on W = 2 and 4, at D = 8 on W = 4, hetero_3d_1 at D = 4 on W = 2)
   within rel 1e-12 with equal Newton iterations and every rank's
   statistics bit-equal, whether bit-equal to phase 19 printed; then
   its production run at W = 4, cut to its first 2 of 4 epochs (8,445
   and 16,953 DoFs; the smoke's time limit): phase 19's DoFs in both
   epochs, TCV within abs 1e-12 and rel 1e-11 in each, equal Newton
   iterations per step, no cut.
   Each rank's device and the transport are printed, and per epoch
   s/step, ms, collectives and bytes per CG iteration, each rank's peak
   device memory, and the card's idle share during the last epoch's
   solves (nvidia-smi utilization samples; no rank runs the profiler).
21. the lattice layout on W ranks of the one card (gloo, staged; each
   rank holds its D / W row slabs of every level split by slab, and the
   sharded kernels read the rows of the neighbour ranks from two
   exchanged halo rows).  Kernels: on W = 4 ranks at the full shapes (2d
   640², 3d 80³ cells, phase 3's seeded inputs) each rank's f32 u and
   phi sharded products (D = 4) equal the rows of the one-process
   sharded product bit for bit, each timed on kernel_clock.py (its halo
   rows exchanged before the clock; the ranks one at a time) beside the
   one-process product, and its exchange timed on the host.  Small:
   phase 4's sharded cases (2d refine 3 at D = 4 on W = 2 and 4, 3d
   refine 1 at D = 4, load step 0, on W = 2) within rel 1e-12 of phase
   4's card runs with equal Newton iterations, every rank bit-equal.
   Full width: phase 7's 2d run (refine 6, 1,232,643 DoFs, two load
   steps, D = 4) on W = 4 ranks: bulk and crack energy within rel 1e-10
   of phase 7's, equal Newton iterations per step, no cut, and every
   rank's sharded-kernel launches equal phase 7's.  Printed: each
   rank's device and the transport, s per step, ms, exchanges,
   collectives and bytes per CG iteration, each rank's peak device
   memory and sharded launches, the card's idle share (nvidia-smi).
22. the seam lattice on W ranks of the one card (gloo, staged; each rank
   holds its D / W row slabs of every level split by slab, the slabs
   seam-aware, the seam's row copies across a rank boundary where it
   runs between the lips), in phase 21's rank processes after phase
   21's work (their one-process references run before).  Small: params/tests/miehe_shear_2.prm at
   refinement 4 (3,315 DoFs) at D = 2 on W = 2 (the seam on the rank
   boundary) and D = 4 on W = 4, and at refinement 5 (12,771 DoFs) at
   D = 2 on W = 2, 3 steps under bench.py's solver settings, every rank
   bit-equal to the one-process card run at the same D, with equal
   Newton iterations.  Full width: phase 17's bench case (refinement 8,
   790,275 DoFs) at D = 4 on W = 4 ranks, load step 0 of phase 17's D
   = 4 run (SEAM_RANKED_STEPS of its 3): bulk energy, crack energy and
   Load x within rel 1e-10 of that run, equal Newton iterations per
   step, no cut, and every rank's sharded-kernel launches per step
   equal its.
   Printed: each rank's device and the transport, s per step, ms,
   exchanges (the seam's own apart), collectives and bytes per CG
   iteration, each rank's peak device memory and launches, the card's
   idle share (nvidia-smi).
23. the replicated cell-axis mode on W ranks of the one card (n_devices
   = D, replicated DoF vectors; gloo, staged): each rank computes the
   per-cell terms of its range of the cells (`sharding.CellRange`,
   JAX's padded shards) and gathers every rank's before the
   one-process ordered scatter, the dense direct solve gathers the
   element matrices, and the lattice solve runs on the rank's row
   slabs; in phase 21's rank processes after phase 22's work (their
   one-process references run before).  Small: sneddon_3d_1 as shipped
   at D = 4 on W = 4 against tests/golden/sneddon_3d_1.mpirun=4.
   statistics under phase 9's rule (its one-process run at D = 4
   bit-equal to phase 9's), threepoint_1 as shipped at D = 2 on W = 2
   against tests/golden/threepoint_1.mpirun=2.statistics under phase
   12's tolerances, miehe_shear_1 under the simple monolithic solver
   on the matrix-free Jacobi CG (3 steps) at D = 2 on W = 2, and
   hetero_3d_1 under the Galerkin GMG's mixed-precision split solve
   (the fine level split by range, the coarse chain on every rank),
   load step 0, at D = 4 on W = 4 against the first row of
   tests/golden/hetero_3d_1.mpirun-4.statistics under phase 14's
   tolerance; every rank bit-equal to the one-process card run at the same D
   (statistics, Newton and linear iterations).  Full width: phase 5's
   2d bench case (refine 6, 1,232,643 DoFs), replicated, at D = 4 on W
   = 4, load step 0: bulk and crack energy within rel 1e-10 of phase
   5's, equal Newton iterations, no cut, the kernels launched on every
   rank.  Printed: each rank's device and the transport, s per step,
   ms, cell gathers, collectives, exchanges and bytes per Newton
   iteration and per CG iteration, each rank's peak device memory
   beside phase 5's, each rank's launches, the card's idle share
   (nvidia-smi).

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
# the small cases' depth: the 3d ones run load step 0 only (their CPU
# runs bound phase 3; the smoke's time limit)
SMALL_STEPS = {2: dict(), 3: dict(max_no_timesteps=0)}
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
    base = dict(n_global_pre_refine=refine, n_local_pre_refine=0,
                n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
                linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
                cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)
    return config.load_parameters(
        os.path.join(ROOT, "params", f"parameters_sneddon_{dim}d.prm"),
        **{**base, **overrides})


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


def small_phases(meanwhile=lambda: None):
    """Each small case, replicated and sharded, on the card vs the plain
    versions on the CPU.  The CPU runs (the 3d ones take minutes of
    plain einsums) go to spawned worker processes at once, splitting the
    host's cores, while the card runs its side and then `meanwhile`
    (the main paths); nothing here is timed.  Returns what `meanwhile`
    returns and the card's sharded runs by dim, (DoFs, energies, its,
    seconds)."""
    jobs = [(dim, refine, n_dofs, ov) for dim, refine, n_dofs in SMALL
            for ov in ({}, SHARDED)]
    # the two 3d runs take minutes, the two 2d runs seconds: the 3d ones
    # get the cores the 2d ones leave
    threads = {2: 1, 3: max(1, ((os.cpu_count() or 4) - 2) // 2)}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(jobs),
                                                mp_context=ctx) as pool:
        cpu = [pool.submit(_run_small, dim, refine,
                           {**SMALL_STEPS[dim], **ov}, "cpu", threads[dim])
               for dim, refine, _, ov in jobs]
        card = [_run_small(dim, refine, {**SMALL_STEPS[dim], **ov}, "cuda")
                for dim, refine, _, ov in jobs]
        out = meanwhile()
        for (dim, refine, n_dofs, ov), fut, on_card in zip(jobs, cpu, card):
            runs = {"cuda": on_card, "cpu": fut.result()}
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
    return out, {dim: run for (dim, _, _, ov), run in zip(jobs, card)
                 if ov}


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
    # the peak without what an earlier run left to the cycle collector
    base = _fresh_memory_baseline()
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
               newton=[e[1] for e in sim.solver_effort],
               peak_bytes=torch.cuda.max_memory_allocated(),
               step_s=[t for _, _, t in sim.step_times])
    print(f"{label}: host setup (forest, mesh) {host_s:.2f} s, "
          f"setup system {sim.timer.wall['Setup system']:.2f} s")
    for (step, newton_its, lin_its, n_active), (_, _, secs) in zip(
            sim.solver_effort, sim.step_times):
        print(f"{label} step {step}: {secs:.2f} s, {newton_its} Newton its,"
              f" {lin_its} linear its, active set {n_active}")
    print(f"{label}: {sim.mesh.n_dofs} DoFs, kernel launches {launches} "
          f"({route_launches} of {route['name']}), sharded-kernel launches "
          f"{sharded}, peak "
          f"device memory {torch.cuda.max_memory_allocated()} B (at its "
          f"start {base} B), energies "
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
    """sneddon_3d_1.prm as shipped: every row of its golden table (the
    golden's columns) and the TCV pin of the JAX package's full test."""
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = _run_quiet(os.path.join(PRM_TESTS, "sneddon_3d_1.prm"),
                     output_dir="")
    names, ours = parse_statistics(sim.statistics.write_text())
    with open(os.path.join(GOLDEN_DIR,
                           "sneddon_3d_1.mpirun=4.statistics")) as f:
        g_names, golden = parse_statistics(f.read())
    fails = (table_failures(ours[:, :len(g_names)], golden, 1e-6, 1e-8)
             if names[:len(g_names)] == g_names
             else [f"columns {names} vs {g_names}"])
    tcv = sim.statistics.data["TCV"][-1]
    print(f"golden 3d (sneddon_3d_1, {len(ours)} rows vs {len(golden)}) on "
          f"cuda: {time.perf_counter() - t0:.2f} s, {sim.mesh.n_dofs} DoFs, "
          f"Newton/linear its {[(e[1], e[2]) for e in sim.solver_effort]},"
          f" rows {ours[:, :len(g_names)].tolist()} vs golden "
          f"{golden.tolist()}, TCV {tcv!r} (0.0399535 +- 1e-5), stencil "
          f"launches {_stencil_counts()}, {len(fails)} cells off")
    if (fails or sim.mesh.n_dofs != 5324 or sim.step_cuts
            or not abs(tcv - 0.0399535) <= 1e-5):
        raise AssertionError("golden 3d: " + "; ".join(fails))
    return ours


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
    """Wrap sim.setup_system, which starts every mesh epoch, and
    sim._refine_and_transfer, which comes before it, to record per
    epoch: its DoFs, the host seconds of the refinement and system setup
    that started it, the solve the mesh takes and, once the next epoch
    starts, the device-memory peak of this one."""
    from cracks_tpu_torch.solvers import newton
    records = []
    refine, setup = sim._refine_and_transfer, sim.setup_system
    refine_s = [0.0]

    def timed_refine(state):
        t0 = time.perf_counter()
        changed = refine(state)
        refine_s[0] = time.perf_counter() - t0
        return changed

    def timed_setup():
        if records:
            records[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        setup()
        torch.cuda.synchronize()
        records.append(dict(dofs=sim.mesh.n_dofs,
                            host_s=refine_s[0] + time.perf_counter() - t0,
                            solve=("halo" if sim.sys.use_halo_state
                                   else newton.check_linear_solver(sim.sys))))
        refine_s[0] = 0.0

    sim._refine_and_transfer = timed_refine
    sim.setup_system = timed_setup
    return records


def _epochs(sim, records, label, reference=None):
    """Print and return one summary per mesh epoch of a finished run.
    A step's Newton and linear iterations are summed over its solves (a
    step the predictor-corrector loop redoes on a refined mesh solves
    twice); the step belongs to the epoch it ended on."""
    records[-1].setdefault("peak_bytes", torch.cuda.max_memory_allocated())
    effort = {}
    for step, newton_its, lin_its, *_ in sim.solver_effort:
        n, lin, solves = effort.get(step, (0, 0, 0))
        effort[step] = (n + newton_its, lin + lin_its, solves + 1)
    steps = [(step, n, secs) + effort[step]
             for step, n, secs in sim.step_times]
    epochs = []
    for dofs in dict.fromkeys(n for _, n, *_ in steps):
        mine = [s for s in steps if s[1] == dofs]
        rec = [r for r in records if r["dofs"] == dofs][-1]
        timed = [s[2] for s in mine if s[0] != 0]   # the first step apart
        ep = dict(dofs=dofs, solve=rec["solve"], host_setup_s=rec["host_s"],
                  peak_bytes=rec["peak_bytes"], step_s=[s[2] for s in mine],
                  its=[(s[3], s[4]) for s in mine],
                  redone=sum(s[5] - 1 for s in mine),
                  s_per_step=(sum(timed) / len(timed) if timed
                              else float("nan")))
        epochs.append(ep)
        ref = ""
        if reference is not None:
            ref = (f" (JAX run, per solve: "
                   f"{[(r['newton'], r['linear']) for r in reference if r['dofs'] == dofs]})")
        print(f"{label} epoch {len(epochs)}: {dofs} DoFs, solve "
              f"{ep['solve']}, refinement + setup {ep['host_setup_s']:.3f}"
              f" s, {len(mine)} steps ({ep['redone']} redone), s/step "
              f"{[round(x, 3) for x in ep['step_s']]} "
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


def production_phase(label="production", instrument=None, **overrides):
    """The shipped file four times finer (last epoch 168,609 DoFs), on
    the Jacobi CG or, with `overrides`, another solve (phases 16, 19;
    `instrument(sim)` is called before the run).
    Returns the epochs, the TCV per epoch, the bulk and crack energy
    per step and the seconds."""
    from cracks_tpu_torch import config, qoi
    from cracks_tpu_torch.driver import Simulation
    t0 = time.perf_counter()
    _zero_stencil_counts()
    p = config.load_parameters(SHIPPED_PRM, output_dir="",
                               **{**PRODUCTION, **overrides})
    sim = Simulation(p, device="cuda", verbose=False)
    records = _instrument_epochs(sim)
    if instrument is not None:
        instrument(sim)
    base = _fresh_memory_baseline()
    sim.run()
    secs = time.perf_counter() - t0
    epochs = _epochs(sim, records, label)
    data = sim.statistics.data
    tcv = [v for v in data["TCV"] if v != ""]
    exact = qoi.tcv_exact(2, p.pressure(time=1.0), p.poisson_ratio_nu)
    errors = [abs(v - exact) for v in tcv]
    values = [v for col in data.values() for v in col
              if isinstance(v, float)]
    print(f"{label} (n_global_pre_refine=2, cg_maxiter=20000"
          f"{''.join(f', {k}={v}' for k, v in overrides.items())}) on cuda: "
          f"{secs:.2f} s, DoFs per epoch {[e['dofs'] for e in epochs]}, "
          f"bulk energy {data['Bulk Energy']!r}, crack energy "
          f"{data['Crack Energy']!r}, "
          f"{sim.step_cuts} time-step cuts, device memory allocated at its "
          f"start {base} B, TCV per epoch {tcv} (exact "
          f"{exact!r}), errors {errors}, stencil launches "
          f"{_stencil_counts()}")
    if sim.step_cuts or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: a time-step cut or a "
                             "non-finite statistic")
    if not min(data["Bulk Energy"]) > 0:
        raise AssertionError(f"{label}: bulk energy not positive")
    if len(tcv) != len(epochs) or not all(
            b < a for a, b in zip(errors, errors[1:])):
        raise AssertionError(f"{label}: the TCV error does not fall "
                             "from epoch to epoch")
    return dict(epochs=epochs, tcv=tcv, secs=secs,
                bulk=list(data["Bulk Energy"]),
                crack=list(data["Crack Energy"]))


# the goldens of the other test cases: (file, golden table, column
# overrides, first softening row, softening overrides), the tolerances
# of the JAX package's full tests
# (tests/test_regression_{adaptive,miehe,threepoint}.py)
GOLDENS = [
    ("miehe_shear_1", "miehe_shear_1.statistics", {}, None, {}),
    ("miehe_shear_2", "miehe_shear_2.statistics",
     {"Energy": (1e-3, 3e-4), "Load": (1e-6, 1e-5)}, 19,
     {"Energy": (1e-3, 1e-3), "Load": (1e-6, 1.3e-3)}),
    ("miehe_tension_adaptive_1", "miehe_tension_adaptive_1.statistics",
     {"Energy": (1e-5, 1.5e-3), "Load": (1e-6, 3e-4)}, 27,
     {"Energy": (1e-3, 1e-2), "Load": (1e-6, 1e-2)}),
    ("threepoint_1", "threepoint_1.mpirun=2.statistics",
     {"Load": (1e-6, 5e-5)}, None, {}),
]
SHIPPED_MIEHE_PRM = os.path.join(ROOT, "params",
                                 "parameters_miehe_shear_adaptive.prm")


def golden_cells(names, ours, g_names, golden, overrides, softening_from,
                 softening):
    """tests/regression.py's compare_statistics: the numdiff rule (|d| <=
    1e-6 or rel <= 1e-8, rel against the larger magnitude), a column's
    (atol, rtol) replaced by the override whose key its name contains,
    from row `softening_from` on by the softening override.  Yields
    (row, column, ours, golden, |d|, atol, rel, rtol) of every compared
    cell."""
    for j, name in enumerate(g_names):
        pick = lambda table, default: next(
            (v for k, v in table.items() if k in name), default)
        tol = pick(overrides, (1e-6, 1e-8))
        soft = pick(softening, tol)
        for i, (g, o) in enumerate(zip(golden[:, j], ours[:, j])):
            if np.isnan(g) and np.isnan(o):
                continue
            a, r = (soft if softening_from is not None
                    and i >= softening_from else tol)
            d = abs(g - o)
            yield i, name, o, g, d, a, d / max(abs(g), abs(o), 1e-300), r


def golden_failures(names, ours, g_names, golden, overrides, softening_from,
                    softening):
    """The failing cells of golden_cells: |d| > atol and rel > rtol."""
    if names[:len(g_names)] != g_names:
        return [f"columns {names} vs {g_names}"]
    if len(ours) != len(golden):
        return [f"{len(ours)} rows vs {len(golden)}"]
    return [f"row {i} col '{name}': {o!r} vs {g!r}"
            for i, name, o, g, d, a, rel, r in golden_cells(
                names, ours, g_names, golden, overrides, softening_from,
                softening)
            if d > a and rel > r]


def golden_margins(names, ours, g_names, golden, overrides, softening_from,
                   softening):
    """Per row, its cells' largest min(|d| / atol, rel / rtol) and that
    cell's column: a cell fails above 1."""
    worst = {}
    for i, name, _, _, d, a, rel, r in golden_cells(
            names, ours, g_names, golden, overrides, softening_from,
            softening):
        m = min(d / a, rel / r)
        if i not in worst or m > worst[i][0]:
            worst[i] = (m, name)
    return [worst[i] for i in sorted(worst)]


def goldens_phase():
    """The four goldens of the non-Sneddon cases, in full, on the card."""
    for name, table, overrides, softening_from, softening in GOLDENS:
        t0 = time.perf_counter()
        _zero_stencil_counts()
        sim = _run_quiet(os.path.join(PRM_TESTS, f"{name}.prm"),
                         output_dir="")
        secs = time.perf_counter() - t0
        names, ours = parse_statistics(sim.statistics.write_text())
        with open(os.path.join(GOLDEN_DIR, table)) as f:
            g_names, golden = parse_statistics(f.read())
        fails = golden_failures(names, ours, g_names, golden, overrides,
                                softening_from, softening)
        margins = (golden_margins(names, ours, g_names, golden, overrides,
                                  softening_from, softening)
                   if len(ours) == len(golden) else [])
        dofs = sim.statistics.data["DoFs"]
        g_dofs = golden[:, g_names.index("DoFs")].astype(int).tolist()
        print(f"golden {name} on cuda: {secs:.2f} s, {len(ours)} rows vs "
              f"{len(golden)}, DoFs {sorted(set(dofs))} (golden "
              f"{sorted(set(g_dofs))}), {sim.step_cuts} time-step cuts, "
              f"{sim.old_pf_retries} old-phase-field retries, {sim.redos} "
              f"redone steps, Newton its per solve "
              f"{[e[1] for e in sim.solver_effort]}, stencil launches "
              f"{_stencil_counts()}, {len(fails)} cells off the golden")
        soft = "" if softening_from is None else (
            f"; softening tolerances from row {softening_from}")
        print(f"golden {name} margins, per row the largest min(|d| / atol, "
              f"rel / rtol) of its cells (a cell fails above 1){soft}: "
              + ", ".join(f"{i}: {m:.2g} {col}"
                          for i, (m, col) in enumerate(margins)))
        if fails or dofs != g_dofs:
            raise AssertionError(f"golden {name}:\n" + "\n".join(fails[:20]))


# the shipped Miehe file's first 100 of its 200 steps: the JAX table's
# 100 rows, the load peak (step 97) and its fall
SHIPPED_MIEHE_STEPS = 100


def shipped_miehe_phase():
    """The shipped Miehe shear file, its first SHIPPED_MIEHE_STEPS
    steps, against the JAX package's table of its first 100 steps, then
    its own checks to the end of the cut."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    name = "parameters_miehe_shear_adaptive"
    with open(os.path.join(REFERENCE_DIR, f"{name}.effort.json")) as f:
        effort = json.load(f)
    with open(os.path.join(REFERENCE_DIR, f"{name}.statistics")) as f:
        ref_names, ref = parse_statistics(f.read())
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = Simulation(config.load_parameters(
        SHIPPED_MIEHE_PRM, output_dir="",
        max_no_timesteps=SHIPPED_MIEHE_STEPS - 1), device="cuda",
        verbose=False)
    records = _instrument_epochs(sim)
    base = _fresh_memory_baseline()
    sim.run()
    secs = time.perf_counter() - t0
    _epochs(sim, records, "shipped Miehe", effort)
    names, ours = parse_statistics(sim.statistics.write_text())
    dofs_col = ref_names.index("DoFs")
    fails = table_failures(ours[:len(ref)], ref, 0.0, 1e-7)
    data = sim.statistics.data
    load = np.asarray(data["Load x"])
    peak = int(np.argmax(load))
    values = [v for col in data.values() for v in col
              if isinstance(v, float)]
    n_steps = len(sim.step_times)
    print(f"shipped Miehe shear on cuda: {secs:.2f} s, {n_steps} steps "
          f"({secs / n_steps:.3f} s/step), DoFs {data['DoFs'][0]} -> "
          f"{data['DoFs'][-1]}, {sim.redos} redone steps (MESH CHANGED), "
          f"{sim.step_cuts} time-step cuts, Load x peak {load[peak]!r} at "
          f"step {peak}, last {load[-1]!r}, device memory allocated at its "
          f"start {base} B, stencil launches {_stencil_counts()}, "
          f"{len(fails)} cells of the first {len(ref)} rows off the JAX "
          f"table (rel 1e-7)")
    if (names != ref_names or len(ours) < len(ref) or fails
            or not np.array_equal(ours[:len(ref), dofs_col],
                                  ref[:, dofs_col])):
        raise AssertionError("shipped Miehe vs the JAX table:\n"
                             + "\n".join(fails[:20]))
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("shipped Miehe: a non-finite statistic")
    if not min(data["Bulk Energy"]) > 0:
        raise AssertionError("shipped Miehe: bulk energy not positive")
    if sim.redos < 1:
        raise AssertionError("shipped Miehe: the mesh never changed")
    if not (peak < len(load) - 1 and load[-1] < load[peak]):
        raise AssertionError("shipped Miehe: Load x does not peak and fall")


SHIPPED_TENSION_PRM = os.path.join(ROOT, "params",
                                   "parameters_miehe_tension_adaptive.prm")
# its first 71 steps: the load peaks at step 64 and falls by 14 % to
# step 70; from step 71 on (above ~4,100 DoFs, K reg = 0 in a developed
# crack) the dense factor is singular and the stored-matrix Jacobi CG
# takes 5,000-21,000 its per step: the 89 steps as shipped took 330.3 s
# on the card (PERF.md)
SHIPPED_TENSION_STEPS = 71


def shipped_tension_phase():
    """Phase 13, second file: the shipped Miehe tension file, its first
    SHIPPED_TENSION_STEPS steps, against the JAX package's table of its
    first 86: every row up to the table's load peak within rel 1e-7
    with equal DoFs; then finite statistics, positive bulk energy and a
    "Load y" that peaks and then falls."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    name = "parameters_miehe_tension_adaptive"
    with open(os.path.join(REFERENCE_DIR, f"{name}.effort.json")) as f:
        effort = json.load(f)
    with open(os.path.join(REFERENCE_DIR, f"{name}.statistics")) as f:
        ref_names, ref = parse_statistics(f.read())
    load_col = ref_names.index("Load y")
    dofs_col = ref_names.index("DoFs")
    ref_peak = int(np.argmax(ref[:, load_col]))
    held = ref[:ref_peak + 1]
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = Simulation(config.load_parameters(
        SHIPPED_TENSION_PRM, output_dir="",
        max_no_timesteps=SHIPPED_TENSION_STEPS - 1),
        device="cuda", verbose=False)
    records = _instrument_epochs(sim)
    base = _fresh_memory_baseline()
    sim.run()
    secs = time.perf_counter() - t0
    _epochs(sim, records, "shipped Miehe tension", effort)
    names, ours = parse_statistics(sim.statistics.write_text())
    fails = table_failures(ours[:len(held)], held, 0.0, 1e-7)
    after = table_failures(ours[len(held):], ref[len(held):len(ours)], 0.0,
                           1e-7)
    data = sim.statistics.data
    load = np.asarray(data["Load y"])
    peak = int(np.argmax(load))
    values = [v for col in data.values() for v in col
              if isinstance(v, float)]
    n_steps = len(sim.step_times)
    print(f"shipped Miehe tension on cuda: {secs:.2f} s, {n_steps} steps "
          f"({secs / n_steps:.3f} s/step), DoFs {data['DoFs'][0]} -> "
          f"{data['DoFs'][-1]}, {sim.redos} redone steps, {sim.step_cuts} "
          f"time-step cuts, Load y peak {load[peak]!r} at step {peak} (JAX "
          f"table: step {ref_peak}), last {load[-1]!r}, device memory "
          f"allocated at its start {base} B, stencil launches "
          f"{_stencil_counts()}; {len(fails)} cells of the {len(held)} rows "
          f"up to the peak off the JAX table (rel 1e-7), {len(after)} in "
          f"the {len(ours) - len(held)} rows after it")
    if (names != ref_names or len(ours) != SHIPPED_TENSION_STEPS or fails
            or not np.array_equal(ours[:len(held), dofs_col],
                                  held[:, dofs_col])):
        raise AssertionError("shipped Miehe tension vs the JAX table:\n"
                             + "\n".join(fails[:20]))
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("shipped Miehe tension: a non-finite "
                             "statistic")
    if not min(data["Bulk Energy"]) > 0:
        raise AssertionError("shipped Miehe tension: bulk energy not "
                             "positive")
    if not (peak < len(load) - 1 and load[-1] < load[peak]):
        raise AssertionError("shipped Miehe tension: Load y does not peak "
                             "and fall")


HETERO_PRM = os.path.join(PRM_TESTS, "hetero_3d_1.prm")
GMG_CG = dict(linear_solver="cg", preconditioner="gmg")
HETERO_MIXED = dict(mixed_precision_cg=True, **GMG_CG)
# phase 15: the parameters_hetero_3d.prm physics on its production mesh
# with bench.py's overrides (_make_params("hetero_3d", 5, "float64",
# "gmg", 3))
HETERO3D_PRM = os.path.join(ROOT, "params", "parameters_hetero_3d.prm")
# its load step 0 (with its redo) of bench.py's 3 (the smoke's time
# limit)
HETERO3D = dict(n_global_pre_refine=5, n_local_pre_refine=5,
                n_refinement_cycles=0, max_no_timesteps=0, output_dir="",
                cg_rtol=1e-8, cg_maxiter=3000, dtype="float64",
                mixed_precision_cg=True, **GMG_CG)


def _run_hetero_cpu(overrides, n_threads):
    """hetero_3d_1 on the CPU with `overrides` (a worker process of
    phase 14): (energies, Newton its per step, linear its per step)."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    torch.set_num_threads(n_threads)
    sim = Simulation(config.load_parameters(HETERO_PRM, output_dir="",
                                            **overrides),
                     device="cpu", verbose=False)
    sim.run()
    return (_energies(sim), [e[1] for e in sim.solver_effort],
            [e[2] for e in sim.solver_effort])


def _lin_per_newton(sim):
    return max(e[2] / e[1] for e in sim.solver_effort)


def hetero_goldens_phase(cpu):
    """Phase 14: hetero_3d_1 (3d, bitmap material, hanging nodes) as
    shipped against its golden; under cg + gmg (the Galerkin GMG, f64)
    against the golden's first row, twice, bit for bit; with mixed
    precision (the split solve) against the CPU port (`cpu`, the future
    of _run_hetero_cpu(HETERO_MIXED), started with phase 12)."""
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = _run_quiet(HETERO_PRM, output_dir="")
    names, ours = parse_statistics(sim.statistics.write_text())
    with open(os.path.join(GOLDEN_DIR,
                           "hetero_3d_1.mpirun-4.statistics")) as f:
        g_names, golden = parse_statistics(f.read())
    fails = golden_failures(names, ours, g_names, golden,
                            {"Energy": (1e-6, 3e-3)}, None, {})
    dofs_ok = np.array_equal(ours[:, g_names.index("DoFs")],
                             golden[:, g_names.index("DoFs")])
    print(f"hetero_3d_1 as shipped on cuda: "
          f"{time.perf_counter() - t0:.2f} s, {len(ours)} rows, DoFs "
          f"{sim.statistics.data['DoFs']}, Newton/linear its per step "
          f"{[(e[1], e[2]) for e in sim.solver_effort]}, stencil "
          f"launches {_stencil_counts()}, {len(fails)} cells off the "
          "golden (Energy columns |d| <= 1e-6 or rel <= 3e-3)")
    if fails or not dofs_ok or sim.step_cuts:
        raise AssertionError("hetero_3d_1 as shipped:\n"
                             + "\n".join(fails))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        sim = _run_quiet(HETERO_PRM, output_dir="", max_no_timesteps=0,
                         **GMG_CG)
        names, ours = parse_statistics(sim.statistics.write_text())
        fails = table_failures(ours[:1], golden[:1], 1e-6, 3e-3)
        runs.append((_energies(sim), sim.solver_effort))
        levels = [int(lv.inject_p.numel())
                  for lv in sim.sys.galerkin_hierarchy.levels]
        print(f"hetero_3d_1 cg + gmg (f64 Galerkin block CG) on cuda: "
              f"{time.perf_counter() - t0:.2f} s, Galerkin levels of "
              f"{levels} vertices, Newton/linear its "
              f"{[(e[1], e[2]) for e in sim.solver_effort]} (at most "
              f"{_lin_per_newton(sim):.1f} per Newton iteration, bound "
              f"60), energies "
              f"{[repr(float(e)) for e in runs[-1][0].ravel()]}"
              f", {len(fails)} cells of the first row off the golden")
        if fails or _lin_per_newton(sim) > 60 or sim.step_cuts:
            raise AssertionError("hetero_3d_1 cg + gmg:\n"
                                 + "\n".join(fails))
    if not (np.array_equal(runs[0][0], runs[1][0])
            and runs[0][1] == runs[1][1]):
        raise AssertionError(f"two card runs of hetero_3d_1 cg + gmg "
                             f"differ: {runs}")
    print("hetero_3d_1 cg + gmg: two card runs bit-equal")
    t0 = time.perf_counter()
    sim = _run_quiet(HETERO_PRM, output_dir="", **HETERO_MIXED)
    secs = time.perf_counter() - t0
    e_cpu, newton_cpu, lin_cpu = cpu.result()
    rel = float(np.max(np.abs(_energies(sim) - e_cpu) / np.abs(e_cpu)))
    newton = [e[1] for e in sim.solver_effort]
    print(f"hetero_3d_1 cg + gmg + mixed precision (the split solve) on "
          f"cuda: {secs:.2f} s, Newton/linear its "
          f"{[(e[1], e[2]) for e in sim.solver_effort]} (CPU port: "
          f"{list(zip(newton_cpu, lin_cpu))}), max relative energy "
          f"difference to the CPU port {rel:.3e} (bound 1e-6)")
    if not rel <= 1e-6 or newton != newton_cpu or sim.step_cuts:
        raise AssertionError("hetero_3d_1 mixed precision: the card and "
                             "the CPU port disagree")


def _phase_timers():
    """Wrap the Galerkin split solve's stages with a synchronizing
    timer: the f32 element build, the level operators (RAP chain,
    diagonals, spectra), the f32 CG passes and the f64 refinement
    passes.  Returns (the seconds per stage, a function that undoes
    the wrapping)."""
    from cracks_tpu_torch.solvers import galerkin
    secs = {}
    saved = {}
    for name, key in (("_g_jac32", "element build"),
                      ("build_level_ops", "level operators"),
                      ("_g_cg_pass32", "f32 CG passes"),
                      ("_g_pass_apply", "f64 refinement passes")):
        fn = saved[name] = getattr(galerkin, name)

        def timed(*args, _fn=fn, _key=key, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            secs[_key] = secs.get(_key, 0.0) + time.perf_counter() - t0
            return out
        setattr(galerkin, name, timed)
    return secs, lambda: [setattr(galerkin, n, f) for n, f in saved.items()]


def _start_trace(**kw):
    """Start a kineto trace of the activities that
    torch.autograd.profiler.profile(**kw) would record; returns a stop()
    that gives its raw events.  Through torch's own calls beneath the
    profiler: its exit would first parse every event into a Python tree
    (tens of seconds per 10^5 launches, where a torch version does that
    eagerly).  Where those calls differ, torch.profiler itself."""
    from torch.autograd import profiler as ap
    prof = ap.profile(use_kineto=True, **kw)
    try:
        try:
            cfg = prof.config(create_trace_id=False)
        except TypeError:
            cfg = prof.config()
        torch.autograd._prepare_profiler(cfg, prof.kineto_activities)
        torch.autograd._enable_profiler(cfg, prof.kineto_activities)
    except (AttributeError, TypeError, RuntimeError):
        prof.__enter__()

        def stop():
            prof.__exit__(None, None, None)
            return prof.kineto_results.events()
        return stop
    return lambda: torch.autograd._disable_profiler().events()


def _profiler(calls):
    """(a dict, wrap): wrap(fn) is fn with a call counter shared by
    every function wrapped this way; the `calls`-th call runs under
    torch.profiler and writes into the dict its wall seconds, summed
    device-kernel seconds, kernel launches and (a tuple result's third
    entry) iterations."""
    out = {}
    n = [0]

    def wrap(fn):
        def wrapped(*args, **kw):
            n[0] += 1
            if n[0] != calls:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            stop = _start_trace(use_cpu=False, use_device="cuda")
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            try:
                events = stop()
            except RuntimeError as e:
                print(f"torch.profiler: {e}")
                return res
            device = [e for e in events
                      if e.device_type() == torch.autograd.DeviceType.CUDA]
            out["device_s"] = sum(e.duration_ns() for e in device) * 1e-9
            out["kernels"] = sum(
                1 for e in device
                if not e.name().startswith(("Memcpy", "Memset")))
            if isinstance(res, tuple) and len(res) >= 3:
                out["its"] = int(res[2])
            return res
        return wrapped
    return out, wrap


def _profile_solve(calls, module=None, name="solve_split"):
    """Wrap `module.name` (galerkin.solve_split by default) so that its
    `calls`-th call runs under torch.profiler: returns (a dict that
    receives that call's wall seconds and summed device-kernel seconds,
    an undo)."""
    if module is None:
        from cracks_tpu_torch.solvers import galerkin as module
    fn = getattr(module, name)
    out, wrap = _profiler(calls)
    setattr(module, name, wrap(fn))
    return out, lambda: setattr(module, name, fn)


def hetero3d_phase():
    """Phase 15: the full-width hetero-3d run (global refinement 5 +
    local pre-refinement 5, the split solve, load step 0)."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = Simulation(config.load_parameters(HETERO3D_PRM, **HETERO3D),
                     device="cuda", verbose=False)
    base = _fresh_memory_baseline()
    secs, undo = _phase_timers()
    # the second Newton solve of the run (step 0, Newton iteration 2)
    # runs under the profiler: step 0's time includes its tracing
    prof, undo_prof = _profile_solve(calls=2)
    try:
        sim.run()
    finally:
        undo()
        undo_prof()
    total = time.perf_counter() - t0
    data = sim.statistics.data
    values = [v for col in data.values() for v in col
              if isinstance(v, float)]
    hier = sim.sys.galerkin_hierarchy
    print(f"hetero-3d production (parameters_hetero_3d.prm, global 5 + "
          f"local 5, cg + gmg + mixed precision, cg_rtol 1e-8) on cuda: "
          f"{total:.2f} s in all, {sim.mesh.n_dofs} DoFs ({sim.mesh.n_cells}"
          f" cells, {len(sim.mesh.hang_child)} hanging vertices), Galerkin "
          f"levels of {[int(lv.inject_p.numel()) for lv in hier.levels]} "
          f"vertices, setup system {sim.timer.wall['Setup system']:.2f} s, "
          f"device memory allocated at its start {base} B, peak "
          f"{torch.cuda.max_memory_allocated()} B")
    for step, dofs, s_step in sim.step_times:
        solves = [e for e in sim.solver_effort if e[0] == step]
        newton_its = sum(e[1] for e in solves)
        lin_its = sum(e[2] for e in solves)
        print(f"hetero-3d step {step}: {dofs} DoFs, {s_step:.2f} s, "
              f"{len(solves)} solves (Newton/linear its "
              f"{[(e[1], e[2]) for e in solves]}), {newton_its} Newton its, "
              f"{lin_its} linear its ({lin_its / newton_its:.1f} per Newton "
              f"iteration), active set {solves[-1][3]}")
    print("hetero-3d stage seconds (synchronized): "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; bulk energy {data['Bulk Energy']!r}, crack energy "
          f"{data['Crack Energy']!r}, stencil launches {_stencil_counts()}")
    if prof.get("device_s", 0.0) > 0:
        print(f"hetero-3d idle share: solve 2 (step 0, Newton iteration 2)"
              f" {prof['wall_s']:.3f} s wall, {prof['device_s']:.3f} s of "
              f"device kernels: idle "
              f"{100 * (1 - prof['device_s'] / prof['wall_s']):.1f} %")
    else:
        print(f"hetero-3d idle share: not measured (the profiler recorded "
              f"no device time: {prof})")
    if (sim.step_cuts or len(sim.step_times) != 1
            or not all(math.isfinite(v) for v in values)
            or not min(data["Bulk Energy"]) > 0
            or _lin_per_newton(sim) > 60):
        raise AssertionError("hetero-3d production: a time-step cut, a "
                             "non-finite statistic, a bulk energy not "
                             "positive or more than 60 linear iterations "
                             "per Newton iteration")


# phase 16 runs the production run's first 2 of its 4 epochs (the
# smoke's time limit)
PRODUCTION_GMG_CYCLES = 1


def production_gmg_phase(jacobi):
    """Phase 16: the production run of phase 11 under the Galerkin GMG,
    with and without mixed precision, cut to its first
    PRODUCTION_GMG_CYCLES + 1 epochs: per epoch its TCV equal to phase
    11's (the Jacobi CG) to rel 1e-6, and the TCV error falling."""
    n_epochs = PRODUCTION_GMG_CYCLES + 1
    for label, ov in (("production gmg + mixed precision",
                       dict(preconditioner="gmg", mixed_precision_cg=True)),
                      ("production gmg f64", dict(preconditioner="gmg"))):
        out = production_phase(
            label, n_refinement_cycles=PRODUCTION_GMG_CYCLES, **ov)
        for i, (a, b) in enumerate(zip(out["epochs"], jacobi["epochs"])):
            print(f"{label} epoch {i + 1}: {a['dofs']} DoFs, solve "
                  f"{a['solve']}, s/step {a['s_per_step']:.3f} (Jacobi "
                  f"{b['s_per_step']:.3f}), linear its per step "
                  f"{[x[1] for x in a['its']]} (Jacobi "
                  f"{[x[1] for x in b['its']]}), TCV {out['tcv'][i]!r} "
                  f"(Jacobi {jacobi['tcv'][i]!r})")
        rel = [abs(a - b) / abs(b) for a, b in zip(out["tcv"],
                                                    jacobi["tcv"])]
        print(f"{label}: {out['secs']:.2f} s (Jacobi {jacobi['secs']:.2f} "
              f"s), TCV relative difference to the Jacobi run per epoch "
              f"{rel} (bound 1e-6)")
        if (len(out["tcv"]) != n_epochs or max(rel) > 1e-6
                or [e["dofs"] for e in out["epochs"]]
                != [e["dofs"] for e in jacobi["epochs"][:n_epochs]]):
            raise AssertionError(f"{label}: the TCV or the epochs differ "
                                 "from the Jacobi run's")
        if any(e["solve"] != "galerkin" for e in out["epochs"]
               if e["dofs"] > 8000):
            raise AssertionError(f"{label}: an epoch above the dense cap "
                                 "did not take the Galerkin GMG")


# phase 17: the seam lattice.  bench.py's miehe_shear case
# (_make_params("miehe_shear", 8, "float64", "gmg", 25): the file
# params/tests/miehe_shear_2.prm, _tpu_overrides at bench.py:95-100 and
# the case at :121-139), rebuilt from the port's own config
MIEHE_PRM = os.path.join(PRM_TESTS, "miehe_shear_2.prm")
MIEHE_BENCH = dict(n_global_pre_refine=8, n_local_pre_refine=0,
                   n_refinement_cycles=0, max_no_timesteps=24, output_dir="",
                   linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
                   cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)
# refine 8: the (514, 513) seam lattice, slit row 256, glued columns
# [0, 257), 7 levels down to (10, 9)
MIEHE_FULL = dict(refine=8, dofs=790_275, grid=(514, 513), seam=(256, 257),
                  levels=7)
# the steps of the full-width run in the smoke (the bench case's 25
# steps are recorded in PERF.md with the command that ran them)
# the bench case's first 3 of bench.py's 25 steps: the whole smoke must
# stay inside its time limit with phase 20 (PERF.md)
MIEHE_FULL_STEPS = 3
MIEHE_SMALL = [(3, 891), (5, 12_771)]
# phase 17's small cases on the CPU: (kind, refinement, DoFs)
SEAM_JOBS = ([("miehe", r, n) for r, n in MIEHE_SMALL]
             + [("mono", 0, 363), ("mono", 1, 1323)])
MIEHE_COLUMNS = ("Bulk Energy", "Crack Energy", "Load x")
# the simple monolithic solver on the Sneddon golden's file, the cases
# of tests/test_torch_monolithic.py: refinement 0 (363 DoFs, the dense
# direct solve) and 1 with cg + gmg + mixed precision (1,323 DoFs, a
# 2-level lattice: the lattice solve with the monolithic flag)
MONO_PRM = os.path.join(PRM_TESTS, "sneddon_2d_1.prm")
MONO = dict(output_dir="", max_no_timesteps=1, n_local_pre_refine=0,
            n_refinement_cycles=0, outer_solver="simple monolithic",
            gamma_penal=100.0)
MONO_LATTICE = dict(linear_solver="cg", preconditioner="gmg",
                    mixed_precision_cg=True, cg_rtol=1e-8)


def _miehe_params(refine, steps, **overrides):
    from cracks_tpu_torch import config
    return config.load_parameters(MIEHE_PRM, **{
        **MIEHE_BENCH, "n_global_pre_refine": refine,
        "max_no_timesteps": steps - 1, **overrides})


def _run_case(kind, refine, overrides, device, n_threads=None):
    """One small seam-lattice case (kind "miehe", 3 steps) or a small
    monolithic case (kind "mono"; refinement 0 the dense solve, 1 the
    lattice): (DoFs, statistics per column and step, (Newton, linear)
    its per step, time-step cuts, seconds).  On the CPU it runs in a
    worker process of seam_small_phase."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    if n_threads:
        torch.set_num_threads(n_threads)
    t0 = time.perf_counter()
    p = (_miehe_params(refine, 3, **overrides) if kind == "miehe"
         else config.load_parameters(MONO_PRM, n_global_pre_refine=refine,
                                     **MONO, **(MONO_LATTICE if refine
                                                else {})))
    sim = Simulation(p, device=device, verbose=False)
    sim.run()
    cols = MIEHE_COLUMNS if kind == "miehe" else MIEHE_COLUMNS[:2]
    hier = sim.sys.lattice_hierarchy
    if ((hier is None) != (kind == "mono" and refine == 0)
            or (hier is not None
                and (kind == "miehe") != (hier.seam is not None))):
        raise AssertionError(f"{kind} refine {refine} on {device}: not the "
                             "expected lattice hierarchy and seam")
    return (sim.mesh.n_dofs,
            np.array([sim.statistics.data[c] for c in cols], dtype=float),
            [(e[1], e[2]) for e in sim.solver_effort], sim.step_cuts,
            time.perf_counter() - t0)


def _agree(label, a, b, bound=(1e-7,), floor=0.0):
    """Energies and loads of two runs (dofs, stats, its, cuts, s) within
    `bound` (per column, the last one for the rest), relative to the
    larger of a value and `floor` times its column's largest value, with
    equal Newton iterations per step."""
    ref = np.maximum(np.abs(b[1]),
                     floor * np.abs(b[1]).max(axis=1, keepdims=True))
    rel = (np.abs(a[1] - b[1]) / ref).max(axis=1)
    bounds = np.array([bound[min(i, len(bound) - 1)]
                       for i in range(len(rel))])
    newton = [[n for n, _ in r[2]] for r in (a, b)]
    print(f"{label}: max relative difference per column "
          f"{[float(f'{r:.3e}') for r in rel]} (bounds {bounds.tolist()}), "
          f"Newton/linear its per step {a[2]} vs {b[2]}, time-step cuts "
          f"{a[3]} / {b[3]}")
    if not (rel <= bounds).all() or newton[0] != newton[1] or a[3] or b[3]:
        raise AssertionError(f"{label}: the runs disagree")


def seam_small_phase(cpu):
    """Phase 17, small: miehe_shear_2.prm at refinement 3 and 5 under the
    bench's solver settings, 3 steps, on the card against the CPU port
    (`cpu`: the futures of each SEAM_JOBS case on the CPU, started with
    phase 16), and on 4 row slabs against the replicated card run; the
    small monolithic Sneddon run, card against CPU."""
    for (kind, r, n_dofs), fut in zip(SEAM_JOBS, cpu):
        _zero_stencil_counts()
        card = _run_case(kind, r, {}, "cuda")
        counts = _stencil_counts()
        host = fut.result()
        name = (f"miehe_shear_2 refine {r}" if kind == "miehe"
                else f"simple monolithic sneddon_2d_1 refine {r}")
        for dev, run in (("cuda", card), ("cpu", host)):
            print(f"{name} on {dev}: {run[0]} DoFs, {run[4]:.1f} s, "
                  f"statistics {run[1].tolist()}")
            if run[0] != n_dofs:
                raise AssertionError(f"{run[0]} DoFs, expected {n_dofs}")
        print(f"{name} on cuda: stencil launches {counts}")
        if (counts[0] > 0) != (r > 0):
            raise AssertionError(f"{name}: {counts[0]} 2d stencil "
                                 "launches")
        if kind == "miehe" or r == 0:
            _agree(f"{name} cuda vs cpu", card, host)
        else:
            # the lattice monolithic run: its step-1 bulk energy
            # (2e-15) is ten orders below step 0's, the rounding
            # floor of the sum; its crack energy (6e-10) is set by
            # how far 1 - phi (~1e-5) has converged when the Newton
            # stops at residual 1e-7, after 24 iterations of step 1
            # at a reduction ~0.97 each (measured 1.2e-7 card vs
            # CPU, 3e-8 port vs JAX on the CPU)
            _agree(f"{name} cuda vs cpu", card, host,
                   bound=(1e-7, 1e-6), floor=1e-6)
        if kind == "miehe":
            _zero_stencil_counts()
            sharded = _run_case(kind, r, SHARDED, "cuda")
            counts = _stencil_counts()
            print(f"{name} sharded (D={D_SHARDS}) on cuda: "
                  f"{sharded[4]:.1f} s, stencil launches {counts}")
            if counts[2] <= 0:
                raise AssertionError(f"{name} sharded: no sharded "
                                     "launch")
            _agree(f"{name} sharded vs replicated on cuda", sharded,
                   card)


def seam_kernel_phase():
    """Phase 17, the seam product on the card at the refine-8 shapes: the
    2d kernel's five products conjugated as collect . kernel . spread
    against the same conjugation of the plain version (TOL), the mirror
    slots zero, and on D_SHARDS slabs (f32 blocks) bit for bit against
    the unsharded seam product; each timed beside the bare kernel."""
    from cracks_tpu_torch.kernel_clock import KernelClock
    from cracks_tpu_torch.ops.stencil import (
        pad_jac_sharded, stencil_matvec, stencil_matvec_reference,
        stencil_matvec_sharded)
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    from cracks_tpu_torch.solvers.lattice import (Seam, seam_collect,
                                                  seam_spread)
    dev = torch.device("cuda")
    grid, seam = MIEHE_FULL["grid"], Seam(*MIEHE_FULL["seam"])
    cells = tuple(g - 1 for g in grid)
    rng = np.random.default_rng(SEED)
    jac64 = torch.as_tensor(rng.standard_normal((12, 12) + cells,
                                                dtype=np.float32),
                            device=dev).to(f64)
    jac64[:, :, seam.s] = 0.0                 # the dead cell row
    x64 = torch.as_tensor(rng.standard_normal((2,) + grid), dtype=f64,
                          device=dev)
    x64[:, seam.s + 1, :seam.slit_lo] = 0.0   # canonical
    clock = KernelClock(dev)
    mesh = make_shard_mesh(["cuda"] * D_SHARDS)
    out = []
    for name, dt, lo_r, hi_r, lo_c, hi_c, k_in, k_out in KERNELS[0]["shapes"]:
        jac = jac64.to(dt)
        X = x64[:k_in].to(dt).contiguous()
        args = (lo_r, hi_r, lo_c, hi_c, k_in, k_out)
        seam_mv = lambda: seam_collect(stencil_matvec(
            jac, seam_spread(X, seam), *args), seam)
        y = seam_mv()
        y_ref = seam_collect(stencil_matvec_reference(
            jac, seam_spread(X, seam), *args), seam)
        torch.cuda.synchronize()
        rtol, atol_rel = TOL[dt]
        scale = float(y_ref.abs().max())
        err = (y - y_ref).abs()
        max_abs_err = float(err.max())
        mirror = float(y[:, seam.s + 1, :seam.slit_lo].abs().max())
        if (not bool((err <= atol_rel * scale + rtol * y_ref.abs()).all())
                or mirror != 0.0 or not bool(torch.isfinite(y).all())):
            raise AssertionError(f"seam product {name}: disagrees with the "
                                 f"plain version, max |err| {max_abs_err:.3e}"
                                 f", mirror {mirror:.3e}")
        diff = None
        if dt == f32 and (lo_r, k_in) == (lo_c, k_out):
            JP = pad_jac_sharded(jac, lo_r, hi_r, lo_c, hi_c, mesh)
            ys = seam_collect(stencil_matvec_sharded(
                JP, seam_spread(X, seam), k_in, mesh), seam)
            torch.cuda.synchronize()
            diff = float((ys - y).abs().max())
            del JP, ys
            if diff != 0.0:
                raise AssertionError(f"sharded seam product {name}: max "
                                     f"|diff| {diff:.3e} to the unsharded")
        ms = clock.median_ms(seam_mv)
        bare_ms = clock.median_ms(lambda: stencil_matvec(jac, X, *args))
        print(f"seam product {name} at {cells} cells (seam {tuple(seam)}): "
              f"max|err| vs plain {max_abs_err:.3e} (max|Y| {scale:.3e}), "
              f"mirror slots 0, sharded (D={D_SHARDS}) - unsharded "
              f"{diff}; spread + kernel + collect {ms * 1e3:.1f} us, the "
              f"kernel alone {bare_ms * 1e3:.1f} us")
        out.append(dict(name=name, max_abs_err=max_abs_err, ms=ms,
                        bare_ms=bare_ms, sharded_diff=diff))
        del jac, X, y, y_ref, err
        torch.cuda.empty_cache()
    del jac64, x64, clock
    torch.cuda.empty_cache()
    return out


def miehe_full_phase():
    """Phase 17, full width: the miehe_shear bench case at refinement 8
    (790,275 DoFs, the 7-level seam lattice), MIEHE_FULL_STEPS steps,
    replicated, then its first 3 steps on 4 row slabs against it."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.solvers import lattice
    t0 = time.perf_counter()
    sim = Simulation(_miehe_params(MIEHE_FULL["refine"], MIEHE_FULL_STEPS),
                     device="cuda", verbose=False)
    host_s = time.perf_counter() - t0
    base = _fresh_memory_baseline()
    # the second Newton solve of the run (step 0, iteration 2) under the
    # profiler: step 0's time includes its tracing
    prof, undo = _profile_solve(2, lattice, "solve_lattice")
    _zero_stencil_counts()
    try:
        sim.run()
    finally:
        undo()
    launches = stencil.stencil_matvec2d.launches
    phi_launches = stencil.stencil_matvec2d.phi_launches
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    hier = sim.sys.lattice_hierarchy
    data = sim.statistics.data
    stats = np.array([data[c] for c in MIEHE_COLUMNS], dtype=float)
    print(f"miehe_shear bench case (refine {MIEHE_FULL['refine']}, cg + gmg +"
          f" mixed precision, cg_rtol 1e-8) on cuda: {sim.mesh.n_dofs} DoFs,"
          f" seam lattice {hier.grid} with seam {tuple(hier.seam)} and "
          f"{hier.n_levels} levels, {len(sim.step_times)} steps in "
          f"{total:.2f} s (host setup {host_s:.2f} s, setup system "
          f"{sim.timer.wall['Setup system']:.2f} s), device memory "
          f"allocated at its start {base} B, peak "
          f"{torch.cuda.max_memory_allocated()} B, kernel launches "
          f"{launches} ({phi_launches} of lattice_stencil2d_phi), "
          f"{sim.step_cuts} time-step cuts")
    for (step, newton_its, lin_its, n_active), (_, _, secs) in zip(
            sim.solver_effort, sim.step_times):
        print(f"miehe_shear step {step}: {secs:.2f} s, {newton_its} Newton "
              f"its, {lin_its} linear its, active set {n_active}")
    timed = [secs for step, _, secs in sim.step_times if step != 0]
    print(f"miehe_shear: s/step {np.mean(timed):.3f} without step 0 "
          f"(median {np.median(timed):.3f}); statistics per step "
          f"{stats.tolist()}")
    if prof.get("device_s", 0.0) > 0:
        print(f"miehe_shear idle share: solve 2 (step 0, Newton iteration "
              f"2) {prof['wall_s']:.3f} s wall, {prof['device_s']:.3f} s of "
              f"device kernels: idle "
              f"{100 * (1 - prof['device_s'] / prof['wall_s']):.1f} %")
    else:
        print(f"miehe_shear idle share: not measured (the profiler "
              f"recorded no device time: {prof})")
    if (sim.mesh.n_dofs != MIEHE_FULL["dofs"]
            or hier.grid != MIEHE_FULL["grid"]
            or tuple(hier.seam) != MIEHE_FULL["seam"]
            or hier.n_levels != MIEHE_FULL["levels"]):
        raise AssertionError("miehe_shear: not the expected seam lattice")
    if (sim.step_cuts or len(sim.step_times) != MIEHE_FULL_STEPS
            or not np.isfinite(stats).all() or not stats[0].min() > 0):
        raise AssertionError("miehe_shear: a time-step cut, a non-finite "
                             "statistic or a bulk energy not positive")
    if not 0 < phi_launches < launches:
        raise AssertionError(f"miehe_shear launched {launches} 2d kernels, "
                             f"{phi_launches} of them phase-field ones")
    newton_its = [e[1] for e in sim.solver_effort]
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _zero_stencil_counts()
    sim = Simulation(_miehe_params(MIEHE_FULL["refine"], 3, **SHARDED),
                     device="cuda", verbose=False)
    per_step, undo = _launches_per_step()
    try:
        sim.run()
    finally:
        undo()
    counts = _stencil_counts()
    sstats = np.array([sim.statistics.data[c] for c in MIEHE_COLUMNS],
                      dtype=float)
    rel = float(np.max(np.abs(sstats - stats[:, :3]) / np.abs(stats[:, :3])))
    snewton = [e[1] for e in sim.solver_effort]
    print(f"miehe_shear sharded (D={D_SHARDS}, dof_sharding=lattice), 3 "
          f"steps on cuda: {time.perf_counter() - t0:.2f} s, s/step "
          f"{[round(x[2], 3) for x in sim.step_times]}, stencil launches "
          f"(2d, 3d, sharded) {counts}, max relative difference to the "
          f"replicated run's first 3 steps {rel:.3e} (bound 1e-7), Newton "
          f"its {snewton} vs {newton_its[:3]}")
    if (not rel <= 1e-7 or snewton != newton_its[:3] or sim.step_cuts
            or counts[2] <= 0 or not sim.sys.use_lattice_state):
        raise AssertionError("miehe_shear sharded: disagrees with the "
                             "replicated run or launched no sharded kernel")
    out = dict(launches=launches, phi_launches=phi_launches,
               sharded=counts[2], sharded_stats=sstats,
               sharded_newton=snewton, sharded_per_step=per_step)
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _launches_per_step():
    """Wrap the lattice-layout Newton so that each load step's solve
    appends the (sharded, unsharded 2d) kernel launches so far to the
    returned list; returns (the list, the undo)."""
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.solvers import lattice_newton
    real = lattice_newton.newton_active_set_lattice
    record = []

    def counted(*args, **kw):
        out = real(*args, **kw)
        record.append((stencil.stencil_matvec_sharded.launches,
                       stencil.stencil_matvec2d.launches))
        return out

    lattice_newton.newton_active_set_lattice = counted

    def undo():
        lattice_newton.newton_active_set_lattice = real
    return record, undo


def seam_phase(cpu):
    """Phase 17: the seam lattice and the monolithic solver (`cpu`: see
    seam_small_phase)."""
    seam_small_phase(cpu)
    products = seam_kernel_phase()
    return dict(products=products, **miehe_full_phase())


# phase 18: the matrix-free operator (assembled_matvec = False): the
# Jacobi CG (f64, or one f32 pass and an f64 correction) and the
# geometric GMG, every Krylov iteration one jvp of the residual (and the
# V-cycle's per smoothing step and level), replayed from a CUDA graph
MATRIX_FREE = dict(linear_solver="cg", cg_rtol=1e-8, cg_maxiter=3000,
                   dtype="float64", assembled_matvec=False)
MF_SOLVES = {
    "jacobi-f64": dict(preconditioner="jacobi", mixed_precision_cg=False),
    "jacobi-mixed": dict(preconditioner="jacobi", mixed_precision_cg=True),
    "gmg": dict(preconditioner="gmg", mixed_precision_cg=False),
}
MIEHE_SHEAR_1_PRM = os.path.join(PRM_TESTS, "miehe_shear_1.prm")
TENSION_1_PRM = os.path.join(PRM_TESTS, "miehe_tension_adaptive_1.prm")
# the small cases, card against CPU: (label, .prm, overrides, DoFs of
# the first step).  The geometric GMG's is the slit mesh's step 0: on
# the CPU the V-cycle's jvps are eager (hundreds of small operations
# each), and the Sneddon file's degraded crack strip takes it thousands
# of iterations per load step
MF_SMALL = [
    ("sneddon 2d refine 3 jacobi-f64", SHIPPED_PRM,
     dict(n_global_pre_refine=3, **MF_SOLVES["jacobi-f64"]), 19_683),
    ("sneddon 2d refine 3 jacobi-mixed", SHIPPED_PRM,
     dict(n_global_pre_refine=3, **MF_SOLVES["jacobi-mixed"]), 19_683),
    # load step 0 only: its CPU run (eager 3d jvps, ~100 s a step) is
    # what phase 18 waits for
    ("sneddon 3d refine 1 step 0 jacobi-mixed",
     os.path.join(ROOT, "params", "parameters_sneddon_3d.prm"),
     dict(n_global_pre_refine=1, max_no_timesteps=0,
          **MF_SOLVES["jacobi-mixed"]), 37_044),
    ("miehe_tension_adaptive_1 step 0 gmg", TENSION_1_PRM,
     dict(max_no_timesteps=0, **MF_SOLVES["gmg"]), 891),
    ("miehe_shear_1 simple monolithic, 3 steps", MIEHE_SHEAR_1_PRM,
     dict(max_no_timesteps=2, outer_solver="simple monolithic"), 891),
]
SNEDDON_ONLY = dict(n_local_pre_refine=0, n_refinement_cycles=0,
                    max_no_timesteps=1)
# the round-1 configuration: Sneddon 2d at refine 4, two load steps; the
# geometric GMG at refine MF_GMG_REFINE, load step 0 only
ROUND1 = dict(refine=4, dofs=77_763)
MF_GMG_REFINE = 3
ROUND1_ORACLE = 2.2449257e-06   # the verify skill's step-0 bulk energy


def _mf_params(prm, overrides):
    from cracks_tpu_torch import config
    base = dict(MATRIX_FREE, output_dir="")
    if "sneddon" in os.path.basename(prm):
        base.update(SNEDDON_ONLY)
    return config.load_parameters(prm, **{**base, **overrides})


def _mf_columns(sim):
    return [c for c in ("Bulk Energy", "Crack Energy", "Load x", "Load y")
            if c in sim.statistics.data]


def _run_mf(prm, overrides, device, n_threads=None, profile_solve=0):
    """One matrix-free run: (DoFs, statistics per column and step,
    (Newton, linear) its per step, time-step cuts, seconds, the solve
    path, seconds per step, the profile of solve `profile_solve` (card
    only)).  On the CPU it runs in a worker process of
    matrix_free_phase."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers import newton
    if n_threads:
        torch.set_num_threads(n_threads)
    t0 = time.perf_counter()
    sim = Simulation(_mf_params(prm, overrides), device=device,
                     verbose=False)
    prof, undo = ({}, lambda: None)
    if profile_solve:
        prof, undo = _profile_solve(profile_solve, newton,
                                    "_solve_matrix_free")
    try:
        sim.run()
    finally:
        undo()
    if device == "cuda":
        torch.cuda.synchronize()
    stats = np.array([sim.statistics.data[c] for c in _mf_columns(sim)],
                     dtype=float)
    return (sim.mesh.n_dofs, stats,
            [(e[1], e[2]) for e in sim.solver_effort], sim.step_cuts,
            time.perf_counter() - t0, newton.check_linear_solver(sim.sys),
            [x[2] for x in sim.step_times], prof)


def _lin_within(label, a, b, share=0.05):
    """Linear iterations per step of two runs within `share` of the
    larger (ROADMAP C9: the f32 passes round otherwise on the card)."""
    la, lb = (np.array([lin for _, lin in r[2]]) for r in (a, b))
    ok = bool((np.abs(la - lb) <= share * np.maximum(la, lb)).all())
    print(f"{label}: linear its per step {la.tolist()} vs {lb.tolist()} "
          f"(within {share:.0%}: {ok})")
    if not ok:
        raise AssertionError(f"{label}: linear iterations differ by more "
                             f"than {share:.0%}")


def _print_profile(label, prof):
    """The idle share and launches per CG iteration of a profiled
    matrix-free solve."""
    if prof.get("device_s", 0.0) > 0 and prof.get("its"):
        print(f"{label} idle share: {prof['wall_s']:.3f} s wall, "
              f"{prof['device_s']:.3f} s of device kernels: idle "
              f"{100 * (1 - prof['device_s'] / prof['wall_s']):.1f} %; "
              f"{prof['kernels']} kernel launches over {prof['its']} CG "
              f"iterations: {prof['kernels'] / prof['its']:.1f} per "
              f"iteration, {1e3 * prof['wall_s'] / prof['its']:.3f} ms "
              f"wall and {1e3 * prof['device_s'] / prof['its']:.3f} ms of "
              f"kernels per iteration")
    else:
        print(f"{label} idle share: not measured (the profiler recorded no "
              f"device time: {prof})")


def _mf_small_card():
    """Phase 18, small, the card's side: each MF_SMALL case on the card
    (no stencil launched).  Returns the runs by label."""
    card = {}
    for label, prm, ov, n_dofs in MF_SMALL:
        _zero_stencil_counts()
        run = card[label] = _run_mf(prm, ov, "cuda")
        counts = _stencil_counts()
        print(f"{label} on cuda: {run[0]} DoFs, solve {run[5]}, "
              f"{run[4]:.1f} s, s/step {[round(x, 3) for x in run[6]]}, "
              f"statistics {run[1].tolist()}")
        if run[0] != n_dofs or run[5] != ("geometric" if "gmg" in label
                                          else "matrix-free"):
            raise AssertionError(f"{label}: {run[0]} DoFs, solve {run[5]}")
        if any(counts):
            raise AssertionError(f"{label}: stencil launches {counts}")
    return card


def _mf_small_compare(card, cpu):
    """Phase 18, small: the card runs against the CPU port's (futures of
    the spawned workers): statistics within rel 1e-7, equal Newton
    iterations per step, linear iterations within 5 % per step."""
    for (label, _, _, _), fut in zip(MF_SMALL, cpu):
        run, host = card[label], fut.result()
        print(f"{label} on cpu: {host[0]} DoFs, solve {host[5]}, "
              f"{host[4]:.1f} s, s/step {[round(x, 3) for x in host[6]]}, "
              f"statistics {host[1].tolist()}")
        _agree(f"{label} cuda vs cpu", run, host)
        _lin_within(f"{label} cuda vs cpu", run, host)


def matrix_free_full_phase(small):
    """Phase 18, the round-1 configuration: Sneddon 2d at refine 4
    (77,763 DoFs), two load steps, under the Jacobi CG in f64 and with
    mixed precision, each held to the JAX package's table
    (tests/torch_reference/sneddon_2d_matrix_free_r4.statistics) to rel
    1e-7 with equal DoFs and to the oracle step-0 bulk energy to rel
    1e-6; then the geometric GMG at refine MF_GMG_REFINE, load step 0,
    its bulk energy within rel 1e-7 of the small f64 Jacobi run's.  No
    time-step cut, finite statistics, positive bulk energy; per step
    the Newton and linear iterations, seconds and peak device memory;
    one profiled solve."""
    with open(os.path.join(REFERENCE_DIR,
                           "sneddon_2d_matrix_free_r4.statistics")) as f:
        ref_names, ref = parse_statistics(f.read())
    bulk_col = ref_names.index("Bulk Energy")
    crack_col = ref_names.index("Crack Energy")
    runs = [("jacobi-f64", ROUND1["refine"], SNEDDON_ONLY["max_no_timesteps"],
             0),
            ("jacobi-mixed", ROUND1["refine"],
             SNEDDON_ONLY["max_no_timesteps"], 2),
            ("gmg", MF_GMG_REFINE, 0, 0)]
    for solve, refine, last_step, profile_solve in runs:
        label = f"matrix-free sneddon 2d refine {refine} {solve}"
        base = _fresh_memory_baseline()
        _zero_stencil_counts()
        run = _run_mf(SHIPPED_PRM, dict(n_global_pre_refine=refine,
                                        max_no_timesteps=last_step,
                                        **MF_SOLVES[solve]),
                      "cuda", profile_solve=profile_solve)
        dofs, stats, its, cuts, secs, path, step_s, prof = run
        peak = torch.cuda.max_memory_allocated()
        print(f"{label} on cuda: {dofs} DoFs, solve {path}, {secs:.2f} s, "
              f"device memory allocated at its start {base} B, peak {peak} "
              f"B, stencil launches {_stencil_counts()}")
        for step, ((n, lin), s) in enumerate(zip(its, step_s)):
            print(f"{label} step {step}: {s:.2f} s, {n} Newton its, {lin} "
                  f"linear its")
        if (cuts or not np.isfinite(stats).all() or not stats[0].min() > 0
                or len(step_s) != last_step + 1):
            raise AssertionError(f"{label}: a time-step cut, a missing "
                                 "step, a non-finite statistic or a bulk "
                                 "energy not positive")
        if profile_solve:
            _print_profile(f"{label} (solve {profile_solve})", prof)
        if refine == ROUND1["refine"]:
            rel = np.abs(stats[:2].T - ref[:, [bulk_col, crack_col]]) / \
                np.abs(ref[:, [bulk_col, crack_col]])
            oracle = abs(stats[0, 0] - ROUND1_ORACLE) / ROUND1_ORACLE
            print(f"{label}: energies {stats[:2].T.tolist()} vs the JAX "
                  f"table {ref[:, [bulk_col, crack_col]].tolist()}: max "
                  f"relative difference {rel.max():.3e} (bound 1e-7); step 0 "
                  f"bulk energy {stats[0, 0]!r} vs the oracle "
                  f"{ROUND1_ORACLE} ({oracle:.2e}, bound 1e-6)")
            if (dofs != ROUND1["dofs"] or not rel.max() <= 1e-7
                    or not oracle <= 1e-6):
                raise AssertionError(f"{label}: off the JAX table")
        else:
            small_run = small[f"sneddon 2d refine {refine} jacobi-f64"]
            rel = abs(stats[0, 0] - small_run[1][0, 0]) / small_run[1][0, 0]
            print(f"{label}: step 0 bulk energy {stats[0, 0]!r} vs the f64 "
                  f"Jacobi run's {small_run[1][0, 0]!r}: relative "
                  f"difference {rel:.3e} (bound 1e-7); Newton its "
                  f"{its[0][0]} vs {small_run[2][0][0]}")
            if not rel <= 1e-7 or its[0][0] != small_run[2][0][0]:
                raise AssertionError(f"{label}: disagrees with the Jacobi "
                                     "run")
        gc.collect()
        torch.cuda.empty_cache()


def mf_cpu_jobs(pool):
    """Phase 18's CPU runs of the small cases, submitted to `pool` (the
    3d one, minutes of eager jvps, with three threads): their
    futures."""
    return [pool.submit(_run_mf, prm, ov, "cpu", 3 if "3d" in label else 1)
            for label, prm, ov, _ in MF_SMALL]


def matrix_free_phase(cpu):
    """Phase 18: the matrix-free operator.  The CPU runs of the small
    cases (`cpu`, the futures of mf_cpu_jobs, started with phase 17)
    are compared when the card has run the small and the full-size
    cases."""
    card = _mf_small_card()
    matrix_free_full_phase(card)
    _mf_small_compare(card, cpu)


# phase 19: the multi-shard modes, D shards on the one card.  The halo
# pool's small cases: the mesh of __graft_entry__.dryrun_multichip's
# halo step, and hetero_3d_1 under tests/test_halo_newton.py's settings
# (BASE, :28-29)
HALO_PRM = MONO_PRM
DRYRUN = dict(n_local_pre_refine=1, value_phase_field_for_refinement=0.5,
              n_refinement_cycles=0, max_no_timesteps=1, linear_solver="cg",
              preconditioner="jacobi", output_dir="")
HALO_BASE = dict(output_dir="", linear_solver="cg", preconditioner="gmg",
                 cg_rtol=1e-10, mixed_precision_cg=True)
HALO_SMALL = [
    ("dryrun halo D=4", HALO_PRM, dict(DRYRUN, n_devices=4,
                                       dof_sharding="lattice"), 453),
    ("dryrun halo D=8", HALO_PRM, dict(DRYRUN, n_devices=8,
                                       dof_sharding="lattice"), 453),
    ("hetero_3d_1 halo D=4", HETERO_PRM, dict(HALO_BASE, n_devices=4,
                                              dof_sharding="lattice"),
     5_288),
]
HALO_CG_CAP = 2000   # solvers/halo_newton.py::HALO_CG_MAXITER


def _run_sharded_mode(prm, overrides, device, n_threads=None):
    """One run of a multi-shard case: (DoFs of the first step,
    statistics per column and step, (Newton, linear) its per step,
    time-step cuts, seconds, the mode, the Newton logs' largest
    block-CG count, (B, n_loc) of the halo partition).  On the CPU it
    runs in a worker process of sharded_modes_phase."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers import halo_newton
    if n_threads:
        torch.set_num_threads(n_threads)
    t0 = time.perf_counter()
    sim = Simulation(config.load_parameters(prm, **overrides), device=device,
                     verbose=False)
    blocks = []
    newton_halo = halo_newton.newton_active_set_halo

    def logged(sys_, state, *args, **kw):
        out = newton_halo(sys_, state, *args, **kw)
        blocks.append(state.last_log.max_block_iterations)
        return out
    halo_newton.newton_active_set_halo = logged
    try:
        sim.run()
    finally:
        halo_newton.newton_active_set_halo = newton_halo
    if device == "cuda":
        torch.cuda.synchronize()
    sys_ = sim.sys
    mode = ("halo" if sys_.use_halo_state else "lattice"
            if sys_.use_lattice_state else "replicated")
    part = sys_.halo_partition
    return (sim.statistics.data["DoFs"][0],
            np.array([sim.statistics.data[c] for c in MIEHE_COLUMNS[:2]],
                     dtype=float),
            [(e[1], e[2]) for e in sim.solver_effort], sim.step_cuts,
            time.perf_counter() - t0, mode, max(blocks, default=0),
            None if part is None else (part.n_pool, part.n_loc))


def _bit_equal(label, a, b):
    """Two card runs (_run_sharded_mode's tuples) with equal statistics
    to the last bit and equal iterations."""
    same = np.array_equal(a[1], b[1]) and a[2] == b[2]
    print(f"{label}: modes {a[5]} / {b[5]}, statistics {a[1].tolist()}, "
          f"Newton/linear its {a[2]} / {b[2]}: bit-equal {same}")
    if not same or a[3] or b[3]:
        raise AssertionError(f"{label}: the runs differ")


def sharded_small_phase():
    """Phase 19, small: the halo cases on the card against the CPU port
    (spawned workers), hetero_3d_1 also against the replicated card
    run; the card-only bit-equalities of the other modes.  Returns the
    2d kernels' launches of the lattice runs and the halo card runs by
    label."""
    ctx = multiprocessing.get_context("spawn")
    # one thread for each dryrun case, the rest for hetero_3d_1 (the
    # longest: ~28 s on two threads, what the phase waited for)
    spare = max(1, (os.cpu_count() or 4) - 1 - (len(HALO_SMALL) - 1))
    with concurrent.futures.ProcessPoolExecutor(len(HALO_SMALL),
                                                mp_context=ctx) as pool:
        cpu = [pool.submit(_run_sharded_mode, prm, ov, "cpu",
                           spare if prm == HETERO_PRM else 1)
               for _, prm, ov, _ in HALO_SMALL]
        card = {}
        for label, prm, ov, n_dofs in HALO_SMALL:
            _zero_stencil_counts()
            run = card[label] = _run_sharded_mode(prm, ov, "cuda")
            counts = _stencil_counts()
            print(f"{label} on cuda: {run[0]} DoFs, mode {run[5]}, pool B "
                  f"and slots per shard {run[7]}, {run[4]:.1f} s, "
                  f"statistics {run[1].tolist()}, Newton/linear its "
                  f"{run[2]}, largest block CG {run[6]}, stencil launches "
                  f"{counts}")
            if run[0] != n_dofs or run[5] != "halo" or any(counts):
                raise AssertionError(f"{label}: {run[0]} DoFs, mode "
                                     f"{run[5]}, stencil launches {counts}")
        # the replicated runs: the f64 Galerkin block CG to cg_rtol, and
        # BASE's mixed precision, the split solve with the fused
        # solve's target at this size, as JAX takes it (C15, closed)
        rep = _run_sharded_mode(HETERO_PRM, dict(HALO_BASE,
                                                 mixed_precision_cg=False),
                                "cuda")
        rep_mixed = _run_sharded_mode(HETERO_PRM, HALO_BASE, "cuda")
        # the matrix-free flag does not reach the pool's stored-matrix CG
        mf = _run_sharded_mode(HALO_PRM, dict(HALO_SMALL[0][2],
                                              assembled_matvec=False),
                               "cuda")
        _bit_equal("dryrun halo D=4, assembled_matvec=False vs True, cuda",
                   mf, card[HALO_SMALL[0][0]])
        launches = sharded_card_only_phase()
        for (label, _, _, _), fut in zip(HALO_SMALL, cpu):
            host = fut.result()
            print(f"{label} on cpu: {host[0]} DoFs, mode {host[5]}, "
                  f"{host[4]:.1f} s, statistics {host[1].tolist()}, "
                  f"largest block CG {host[6]}")
            _agree(f"{label} cuda vs cpu", card[label], host)
    # JAX's np1/np8 tolerance (tests/test_halo_newton.py:44-49): every
    # entry within abs 1e-6 or rel 1e-7
    halo = card[HALO_SMALL[2][0]]
    for label, run in (("mixed-precision split solve", rep_mixed),
                       ("f64 Galerkin block CG", rep)):
        d = np.abs(halo[1] - run[1])
        ok = bool(((d <= 1e-6) | (d <= 1e-7 * np.abs(run[1]))).all())
        print(f"hetero_3d_1 halo D=4 vs replicated ({label}) on cuda "
              f"({run[4]:.1f} s, Newton/linear its {run[2]}, statistics "
              f"{run[1].tolist()}): max abs difference {d.max():.3e}, max "
              f"rel {float((d / np.abs(run[1])).max()):.3e} (abs 1e-6 or "
              f"rel 1e-7: {ok})")
        if not ok or run[3] or [n for n, _ in run[2]] != [
                n for n, _ in halo[2]]:
            raise AssertionError(f"hetero_3d_1: the halo pool and the "
                                 f"replicated run ({label}) disagree")
    return launches, card


def sharded_card_only_phase():
    """Phase 19, on the card alone: replicated vectors at n_devices = 4
    are the one-device run; the (2, 2) product mesh is the flat D = 4
    lattice run, its sharded kernel launched; the monolithic solver
    falls back to replicated vectors."""
    sneddon = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
    lattice_run = dict(n_global_pre_refine=3, n_local_pre_refine=0,
                       n_refinement_cycles=0, max_no_timesteps=1,
                       output_dir="", linear_solver="cg",
                       preconditioner="gmg", cg_rtol=1e-8, cg_maxiter=3000,
                       dtype="float64", mixed_precision_cg=True)
    pairs = [("replicated n_devices=4 vs 1, sneddon 2d refine 3", sneddon,
              dict(lattice_run, n_devices=4), lattice_run),
             ("mesh_dcn=2 vs flat, n_devices=4 dof_sharding=lattice, "
              "sneddon 2d refine 3", sneddon,
              dict(lattice_run, mesh_dcn=2, **SHARDED),
              dict(lattice_run, **SHARDED)),
             ("simple monolithic, dof_sharding=lattice n_devices=4 vs 1, "
              "sneddon_2d_1 refine 1", MONO_PRM,
              dict(MONO, **MONO_LATTICE, n_global_pre_refine=1, **SHARDED),
              dict(MONO, **MONO_LATTICE, n_global_pre_refine=1))]
    from cracks_tpu_torch.ops import stencil
    launches = dict(phi=0, rest=0, sharded=0)
    for label, prm, ov, base in pairs:
        _zero_stencil_counts()
        a = _run_sharded_mode(prm, ov, "cuda")
        counts = _stencil_counts()
        phi = stencil.stencil_matvec2d.phi_launches
        launches["phi"] += phi
        launches["rest"] += counts[0] - phi
        launches["sharded"] += counts[2]
        b = _run_sharded_mode(prm, base, "cuda")
        print(f"{label}: {a[0]} DoFs, {a[4]:.1f} s, stencil launches "
              f"{counts}")
        _bit_equal(label, a, b)
        want = "lattice" if "mesh_dcn" in label else "replicated"
        if a[5] != want or (want == "lattice") != (counts[2] > 0):
            raise AssertionError(f"{label}: mode {a[5]}, sharded launches "
                                 f"{counts[2]}")
    return launches


def _profile_halo_solve(calls):
    """Run the `calls`-th halo block-CG solve (each Newton solve builds
    its own, `halo_newton.build_halo_cg`) under torch.profiler: returns
    (the dict of `_profiler`, an undo)."""
    from cracks_tpu_torch.solvers import halo_newton
    build = halo_newton.build_halo_cg
    out, wrap = _profiler(calls)
    halo_newton.build_halo_cg = lambda *a, **kw: wrap(build(*a, **kw))
    return out, lambda: setattr(halo_newton, "build_halo_cg", build)


def sharded_full_phase(jacobi):
    """Phase 19, full width: phase 11's production run at n_devices =
    4, dof_sharding = lattice (the halo pool on every epoch) against
    phase 11's epochs and TCV.  Returns production_phase's dict."""
    from cracks_tpu_torch.solvers import halo_newton
    pools, blocks = [], []
    newton_halo = halo_newton.newton_active_set_halo

    def instrument(sim):
        setup = sim.setup_system

        def recorded():
            setup()
            part = sim.sys.halo_partition
            pools.append((sim.mesh.n_dofs, part.n_pool, part.n_loc))
        sim.setup_system = recorded

        def logged(sys_, state, *args, **kw):
            out = newton_halo(sys_, state, *args, **kw)
            blocks.append((sys_.mesh.n_dofs,
                           state.last_log.max_block_iterations))
            return out
        halo_newton.newton_active_set_halo = logged

    # a solve of the last epoch: 4 epochs of 4 steps of 2 Newton
    # iterations (phase 11)
    prof, undo = _profile_halo_solve(27)
    try:
        out = production_phase("production halo", instrument=instrument,
                               **SHARDED)
    finally:
        undo()
        halo_newton.newton_active_set_halo = newton_halo
    epochs = out["epochs"]
    if [e["dofs"] for e in epochs] != [e["dofs"] for e in jacobi["epochs"]]:
        raise AssertionError("production halo: DoFs per epoch differ from "
                             "phase 11's")
    for i, (ep, tcv, tcv_ref) in enumerate(zip(epochs, out["tcv"],
                                               jacobi["tcv"])):
        pool = [p for p in pools if p[0] == ep["dofs"]][-1]
        top = max(b for d, b in blocks if d == ep["dofs"])
        rel = abs(tcv - tcv_ref) / abs(tcv_ref)
        capped = top >= HALO_CG_CAP
        print(f"production halo epoch {i + 1}: {ep['dofs']} DoFs, mode "
              f"{ep['solve']}, pool B {pool[1]}, {pool[2]} slots per shard "
              f"of {ep['dofs'] // 3} vertices, largest block CG {top} (cap "
              f"{HALO_CG_CAP}{', reached' if capped else ''}), TCV "
              f"{tcv!r} vs phase 11's {tcv_ref!r}: rel {rel:.3e} (bound "
              f"1e-6{', exempt: a block CG reached its cap' if capped else ''})")
        if ep["solve"] != "halo" or (rel > 1e-6 and not capped):
            raise AssertionError(f"production halo epoch {i + 1}: mode "
                                 f"{ep['solve']}, TCV off phase 11's")
    if prof.get("device_s", 0.0) > 0 and prof.get("its"):
        print(f"production halo idle share (solve 27, of the last "
              f"epoch): {prof['wall_s']:.3f} s wall, "
              f"{prof['device_s']:.3f} s of device kernels: idle "
              f"{100 * (1 - prof['device_s'] / prof['wall_s']):.1f} %; "
              f"{prof['kernels']} kernel launches over {prof['its']} CG "
              f"iterations: {prof['kernels'] / prof['its']:.1f} per "
              f"iteration, {1e3 * prof['wall_s'] / prof['its']:.3f} ms wall "
              f"per iteration")
    else:
        print(f"production halo idle share: not measured ({prof})")
    return out


def sharded_modes_phase(jacobi):
    """Phase 19: the multi-shard modes on the one card.  Returns the 2d
    kernels' launches in its lattice runs (the halo pool launches
    none), its small halo card runs ("small") and its production run
    ("production"): phase 20's references."""
    launches, card = sharded_small_phase()
    return dict(launches, small=card, production=sharded_full_phase(jacobi))


# phase 20: the halo pool on W ranks of the one card.  The ranks share
# the card, so the transport is gloo with CUDA tensors staged through
# pinned host buffers (NCCL refuses two ranks on one device); each rank
# holds D / W shards.  Small: phase 19's halo cases at W = 2 and 4;
# full width: phase 19's production run at W = 4.  Phase 19's card runs
# are the references.
RANKED_SMALL = [
    (f"{label} W={W}", prm, ov, W, label)
    for (label, prm, ov, _), worlds in zip(HALO_SMALL, ((2, 4), (4,), (2,)))
    for W in worlds]
RANKED_FULL_W = 4
# phase 20's production run: its first RANKED_EPOCHS of 4 epochs (8,445
# and 16,953 DoFs, 4 load steps each; the smoke's time limit: the 48,321-
# and 168,609-DoF epochs took 84 and 72 s of its 227 s on W = 4 ranks
# with the last one cut to 2 steps; phase 19 runs all four on the same
# pool)
RANKED_EPOCHS = 2


def _host_resident_bytes():
    """This process's resident host memory now (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _rank_info(ranks):
    from cracks_tpu_torch.parallel import dist
    return dict(rank=ranks.rank, device=str(ranks.device),
                transport=dist.describe(ranks),
                peak_bytes=(torch.cuda.max_memory_allocated()
                            if ranks.device.type == "cuda" else 0),
                host_bytes=_host_resident_bytes())


def _ranked_cases(ranks, cases, production):
    """A rank of a phase-20 launch: each small case's
    _run_sharded_mode tuple, the rank's device, transport and peak
    memory after them, and with `production` then the production run
    (_ranked_production's dict)."""
    small = [_run_sharded_mode(prm, ov, ranks.device.type)
             for prm, ov in cases]
    return (small, _rank_info(ranks),
            _ranked_production(ranks) if production else None)


def _ranked_production(ranks):
    """A rank of the phase-20 production run: production_phase's dict
    (printed by rank 0 alone), every halo solve's (DoFs, synchronized
    wall seconds, CG iterations, collectives, bytes, start and end on
    the host's clock), and the rank's device, transport and peak
    memory.  No rank runs torch.profiler: the device's idle share comes
    from nvidia-smi's utilization samples (`_gpu_sampler`)."""
    from cracks_tpu_torch.parallel import dist
    from cracks_tpu_torch.solvers import halo_newton
    if ranks.rank:
        sys.stdout = open(os.devnull, "w")
    build = halo_newton.build_halo_cg
    solves = []

    def timed_build(part, **kw):
        solve = build(part, **kw)

        def timed(*args, **kws):
            torch.cuda.synchronize()
            c0, b0 = dist.COUNTS["collectives"], dist.COUNTS["bytes"]
            t0, w0 = time.perf_counter(), time.time()
            out = solve(*args, **kws)
            torch.cuda.synchronize()
            solves.append((part.n_vertices * (part.dim + 1),
                           time.perf_counter() - t0, int(out[2]),
                           dist.COUNTS["collectives"] - c0,
                           dist.COUNTS["bytes"] - b0, w0, time.time()))
            d, w, its, c = solves[-1][:4]
            print(f"  solve {len(solves)}: {d} DoFs, {its} CG its, "
                  f"{1e3 * w / max(its, 1):.3f} ms and "
                  f"{c / max(its, 1):.2f} collectives per iteration",
                  flush=True)
            return out
        return timed

    halo_newton.build_halo_cg = timed_build
    try:
        out = production_phase(f"production halo W={ranks.world}",
                               n_refinement_cycles=RANKED_EPOCHS - 1,
                               **SHARDED)
    finally:
        halo_newton.build_halo_cg = build
    return dict(out, solves=solves, **_rank_info(ranks))


def _gpu_sampler(stop, samples):
    """Until `stop` is set: every 2 s, (host time, the card's
    utilization.gpu in %: the share of the last sample period in which
    a kernel ran) from nvidia-smi (polled every 0.5 s it slowed a
    collective by ~10 %, scripts/bench_rank_transport.py)."""
    while not stop.wait(2.0):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30)
        if smi.returncode == 0 and smi.stdout.strip().isdigit():
            samples.append((time.time(), int(smi.stdout.strip())))


def _host_guard(stop, floor_bytes=12 << 30):
    """Until `stop` is set: every 2 s, if the host's available memory
    falls below `floor_bytes`, kill this process's children (the
    launch then fails on the dead ranks) rather than let the machine
    run out."""
    while not stop.wait(2.0):
        with open("/proc/meminfo") as f:
            info = dict(line.split(":", 1) for line in f)
        avail = int(info["MemAvailable"].split()[0]) * 1024
        if avail < floor_bytes:
            print(f"host memory guard: {avail} B available, killing the "
                  "ranks", flush=True)
            for child in multiprocessing.active_children():
                child.kill()


def _launch_on_card(fn, world, args, tmp, samples=None):
    """dist.launch under the host-memory guard; with `samples` (a list)
    nvidia-smi's utilization samples of the card are appended to it
    meanwhile."""
    import threading
    from cracks_tpu_torch.parallel import dist
    stop = threading.Event()
    threads = [threading.Thread(target=_host_guard, args=(stop,),
                                daemon=True)]
    if samples is not None:
        threads.append(threading.Thread(target=_gpu_sampler,
                                        args=(stop, samples), daemon=True))
    for t in threads:
        t.start()
    try:
        return dist.launch(fn, world, args=args, device="cuda",
                           rendezvous_dir=tmp, timeout_s=300,
                           deadline_s=900,
                           n_threads=max(1, (os.cpu_count() or 8) // world))
    finally:
        stop.set()
        for t in threads:
            t.join()


def ranked_small_phase(entries, outs, card, secs):
    """Phase 20, small: each case on W ranks within rel 1e-12 of phase
    19's one-process card run, with equal Newton iterations, all ranks
    bit-equal."""
    infos = [o[1] for o in outs]
    W = len(outs)
    print(f"phase 20 on cuda, {W} ranks ("
          + "; ".join(f"rank {i['rank']} on {i['device']}" for i in infos)
          + f"), {infos[0]['transport']}: {secs:.1f} s with the ranks' "
          f"start, peak device memory per rank after the small cases "
          f"{[i['peak_bytes'] for i in infos]} B, resident host memory "
          f"per rank then {[i['host_bytes'] for i in infos]} B")
    for n, (label, _, _, _, ref_label) in enumerate(entries):
        ref = card[ref_label]
        run = outs[0][0][n]
        same_ranks = all(np.array_equal(o[0][n][1], run[1])
                         and o[0][n][2] == run[2] for o in outs)
        bits = np.array_equal(run[1], ref[1]) and run[2] == ref[2]
        rel = float((np.abs(run[1] - ref[1]) / np.abs(ref[1])).max())
        print(f"{label} on cuda: {run[4]:.1f} s, mode {run[5]}, "
              f"statistics {run[1].tolist()}, Newton/linear its {run[2]} "
              f"(phase 19: {ref[2]}, {ref[4]:.1f} s), max rel difference "
              f"to phase 19 {rel:.3e} (bound 1e-12), bit-equal to phase "
              f"19: {bits}, ranks bit-equal: {same_ranks}")
        if (run[5] != "halo" or rel > 1e-12 or not same_ranks or run[3]
                or [n for n, _ in run[2]] != [n for n, _ in ref[2]]):
            raise AssertionError(f"{label}: off phase 19's run")


def ranked_full_phase(outs, samples, production):
    """Phase 20, full width: phase 19's production run on W = 4 ranks,
    its first RANKED_EPOCHS epochs: phase 19's DoFs in every epoch, TCV
    within abs 1e-12 and rel 1e-11 in every epoch, equal Newton
    iterations per step, no time-step cut (production_phase's gate); per
    epoch s/step, ms, collectives and bytes per CG iteration, and each
    rank's peak memory; the device's idle share during the last epoch's
    solves from nvidia-smi's samples."""
    W = len(outs)
    out = outs[0]
    print(f"production halo W={W}: {out['secs']:.2f} s in rank 0's run "
          f"(phase 19 {production['secs']:.2f} s), "
          + "; ".join(f"rank {o['rank']} on {o['device']}" for o in outs)
          + f", {out['transport']}, resident host memory per rank at "
          f"its end {[o['host_bytes'] for o in outs]} B")
    ref_epochs = production["epochs"][:RANKED_EPOCHS]
    if [e["dofs"] for e in out["epochs"]] != [e["dofs"] for e in ref_epochs]:
        raise AssertionError(f"production halo W={W}: DoFs per epoch "
                             "differ from phase 19's")
    for o in outs[1:]:
        if (o["tcv"], o["bulk"], o["crack"]) != (out["tcv"], out["bulk"],
                                                 out["crack"]):
            raise AssertionError(f"production halo W={W}: rank "
                                 f"{o['rank']}'s statistics differ from "
                                 "rank 0's")
    for i, (ep, ref) in enumerate(zip(out["epochs"], ref_epochs)):
        mine = [s for s in out["solves"] if s[0] == ep["dofs"]]
        wall, its, coll, nbytes = (sum(s[k] for s in mine)
                                   for k in (1, 2, 3, 4))
        newton = [n for n, _ in ep["its"]]
        newton_ref = [n for n, _ in ref["its"]]
        tcv, tcv_ref = out["tcv"][i], production["tcv"][i]
        diff = abs(tcv - tcv_ref)
        ok = diff <= 1e-12 and diff <= 1e-11 * abs(tcv_ref)
        gate = (f"TCV {tcv!r} vs phase 19's {tcv_ref!r}: {diff:.3e} "
                f"apart (bound 1e-12), rel {diff / abs(tcv_ref):.3e} "
                "(bound 1e-11)")
        print(f"production halo W={W} epoch {i + 1}: {ep['dofs']} DoFs, "
              f"s/step {[round(x, 3) for x in ep['step_s']]} (phase 19 "
              f"{[round(x, 3) for x in ref['step_s']]}), Newton/linear "
              f"its per step {ep['its']} (phase 19 {ref['its']}), "
              f"{1e3 * wall / max(its, 1):.3f} ms per CG iteration over "
              f"{len(mine)} solves, {coll / max(its, 1):.2f} collectives "
              f"and {nbytes / max(its, 1):.0f} B per CG iteration per "
              f"rank, {gate}, peak memory per "
              f"rank {[o['epochs'][i]['peak_bytes'] for o in outs]} B (phase "
              f"19: {ref['peak_bytes']} B)")
        if not ok or newton != newton_ref:
            raise AssertionError(f"production halo W={W} epoch {i + 1}: "
                                 "statistics or Newton iterations off "
                                 "phase 19's")
    last = [(a, b) for d, _, _, _, _, a, b in out["solves"]
            if d == out["epochs"][-1]["dofs"]]
    busy = [u for t, u in samples if any(a <= t <= b for a, b in last)]
    if busy:
        share = sum(busy) / len(busy)
        print(f"production halo W={W} idle share during the last epoch's "
              f"{len(last)} solves: {100 - share:.1f} % (nvidia-smi "
              f"utilization.gpu, {len(busy)} samples, mean busy "
              f"{share:.1f} %; {len(samples)} samples over the run, mean "
              f"busy {sum(u for _, u in samples) / len(samples):.1f} %)")
    else:
        print(f"production halo W={W} idle share: not measured "
              f"({len(samples)} samples)")


def ranked_phase(multi):
    """Phase 20: the halo pool on W ranks of the one card, held to
    phase 19's runs: one launch per W, its small cases, and at
    RANKED_FULL_W then the production run."""
    worlds = {}
    for entry in RANKED_SMALL:
        worlds.setdefault(entry[3], []).append(entry)
    for W, entries in sorted(worlds.items()):
        production = W == RANKED_FULL_W
        samples = [] if production else None
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outs = _launch_on_card(
                _ranked_cases, W,
                ([(prm, ov) for _, prm, ov, _, _ in entries], production),
                tmp, samples)
        ranked_small_phase(entries, outs, multi["small"],
                           time.perf_counter() - t0)
        if production:
            ranked_full_phase([o[2] for o in outs], samples,
                              multi["production"])


# phase 21: (label, dim, W) of the small cases, the full-width W
LATTICE_SMALL = [("2d refine 3 lattice D=4 W=2", 2, 2),
                 ("2d refine 3 lattice D=4 W=4", 2, 4),
                 ("3d refine 1 lattice D=4 W=2", 3, 2)]
LATTICE_FULL_W = 4


def _ranked_products(ranks):
    """A rank of phase 21's kernel check: for each KERNELS library at its
    full shapes (phase 3's seeded inputs) the f32 u and phi blocks'
    sharded products on D_SHARDS shards, one process (all rows) and
    this rank (its rows, the halo rows exchanged), compared bit for bit;
    the rank's product timed on kernel_clock.py with the halo rows in
    hand, the ranks one at a time, beside the one-process product (each
    rank times that too), and the exchange's host time."""
    import torch.distributed as tdist
    from cracks_tpu_torch.kernel_clock import KernelClock
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    dev = ranks.device
    one = make_shard_mesh([dev] * D_SHARDS)
    mesh = make_shard_mesh([dev] * D_SHARDS, ranks=ranks)
    clock = KernelClock(dev)
    out = []
    for spec in KERNELS:
        cells, dim = spec["cells"], spec["dim"]
        ndl = 2 ** dim * (dim + 1)
        grid = tuple(c + 1 for c in cells)
        rng = np.random.default_rng(SEED)
        jac = torch.as_tensor(rng.standard_normal((ndl, ndl) + cells,
                                                  dtype=np.float32),
                              device=dev)
        x = torch.as_tensor(rng.standard_normal((dim,) + grid), dtype=f64,
                            device=dev)
        rl = one.rows_loc(grid[0])
        r0 = mesh.first * rl
        r1 = min(r0 + mesh.n_local * rl, grid[0])
        for name, dt, lo, hi, _, _, k, _ in spec["shapes"]:
            if dt != f32:
                continue
            X = x[:k].to(f32).contiguous()
            JP1 = stencil.pad_jac_sharded(jac, lo, hi, lo, hi, one)
            y1 = stencil.stencil_matvec_sharded(JP1, X, k, one)
            JP = stencil.pad_jac_sharded(jac[:, :, r0:r1].contiguous(), lo,
                                         hi, lo, hi, mesh, rows_loc=rl)
            Xr = X[:, r0:r1].contiguous()
            before = stencil.stencil_matvec_sharded.launches
            y = stencil.stencil_matvec_sharded(JP, Xr, k, mesh)
            launches = stencil.stencil_matvec_sharded.launches - before
            torch.cuda.synchronize()
            diff = float((y - y1[:, r0:r1]).abs().max())
            equal = torch.equal(y, y1[:, r0:r1])
            halo = stencil.halo_rows(Xr, mesh)
            t0 = time.perf_counter()
            for _ in range(20):
                stencil.halo_rows(Xr, mesh)
            exchange_ms = (time.perf_counter() - t0) / 20 * 1e3
            ms = one_ms = None
            for r in range(ranks.world):
                tdist.barrier()
                if r == ranks.rank:
                    ms = clock.median_ms(
                        lambda: stencil.stencil_matvec_sharded(
                            JP, Xr, k, mesh, halo=halo))
                    one_ms = clock.median_ms(
                        lambda: stencil.stencil_matvec_sharded(JP1, X, k, one))
            # what the rank's launch must move, as phase 3 counts the
            # one-process product's: J's cell rows of the rank's rows
            # (the carrier's pad rows past the lattice's end are never
            # read) and one J halo row per shard that holds rows; X's
            # rows and Y's, and the X halo rows it receives
            kl = hi - lo
            cells_r = min(r1, grid[0] - 1) - r0
            shards_r = sum(1 for s in range(mesh.n_local)
                           if (mesh.first + s) * rl < grid[0])
            halos = int(r0 > 0) + int(r1 < grid[0])
            rest, vrow = int(np.prod(cells[1:])), int(np.prod(grid[1:]))
            nbytes = 4 * (kl * kl * (cells_r + shards_r) * rest
                          + 2 * k * (r1 - r0) * vrow + k * halos * vrow)
            out.append(dict(library=spec["sharded"], name=name, rows=(r0, r1),
                            carrier=tuple(JP.shape), launches=launches,
                            max_abs_diff=diff, equal=equal, ms=ms,
                            one_ms=one_ms, exchange_ms=exchange_ms,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
            del JP1, y1, JP, y, X, Xr
            torch.cuda.empty_cache()
        del jac, x
        torch.cuda.empty_cache()
    del clock
    torch.cuda.empty_cache()
    return out


def _ranked_lattice_full(ranks):
    """A rank of phase 21's full-width run: phase 7's 2d case on the
    ranks, with every CG pass timed between synchronizations and its
    exchanges, collectives and bytes counted."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.parallel import dist
    from cracks_tpu_torch.solvers import lattice
    if ranks.rank:
        sys.stdout = open(os.devnull, "w")
    real = lattice._cg_pass32
    passes = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        e0, c0 = dict(dist.EXCHANGES), dict(dist.COUNTS)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0, out[1],
                       dist.EXCHANGES["exchanges"] - e0["exchanges"],
                       dist.COUNTS["collectives"] - c0["collectives"],
                       dist.EXCHANGES["bytes"] - e0["bytes"]
                       + dist.COUNTS["bytes"] - c0["bytes"]))
        return out

    sim = Simulation(_params(2, FULL[2][0], **SHARDED), device="cuda",
                     verbose=ranks.rank == 0)
    torch.cuda.reset_peak_memory_stats()
    _zero_stencil_counts()
    lattice._cg_pass32 = timed
    t0 = time.perf_counter()
    try:
        sim.run()
    finally:
        lattice._cg_pass32 = real
    torch.cuda.synchronize()
    hier = sim.sys.lattice_hierarchy
    return dict(energies=_energies(sim), newton=[e[1] for e in
                                                sim.solver_effort],
                linear=[e[2] for e in sim.solver_effort],
                steps=len(sim.solver_effort), cuts=sim.step_cuts,
                step_s=[t for _, _, t in sim.step_times],
                secs=time.perf_counter() - t0,
                sharded=stencil.stencil_matvec_sharded.launches,
                unsharded=stencil.stencil_matvec2d.launches,
                phi=stencil.stencil_matvec2d.phi_launches,
                n_split=hier.n_split, n_levels=hier.n_levels,
                rows=(hier.slabs[-1].a, hier.slabs[-1].b), passes=passes,
                **_rank_info(ranks))


def _ranked_lattice(ranks, dims, kernels, full, seam=None,
                    replicated=None):
    """A rank of a phase-21 launch: with `kernels` the kernel check,
    then each small case's _run_small tuple (dims), then with `full` the
    full-width run; then with `seam` (`_ranked_seam`'s arguments) phase
    22's work and with `replicated` (`_ranked_replicated`'s) phase 23's
    in the same process, which spares them the ranks' start and their
    first CUDA calls."""
    from cracks_tpu_torch.ops import stencil
    prods = _ranked_products(ranks) if kernels else None
    small = []
    for dim in dims:
        _zero_stencil_counts()
        run = _run_small(dim, SMALL[[d for d, _, _ in SMALL].index(dim)][1],
                         {**SMALL_STEPS[dim], **SHARDED}, "cuda")
        kernel = (stencil.stencil_matvec2d if dim == 2
                  else stencil.stencil_matvec3d)
        small.append(run + ((stencil.stencil_matvec_sharded.launches,
                              kernel.launches),))
    info = _rank_info(ranks)
    full = _ranked_lattice_full(ranks) if full else None
    return (prods, small, info, full,
            None if seam is None else _ranked_seam(ranks, *seam),
            None if replicated is None
            else _ranked_replicated(ranks, *replicated))


def _lattice_kernel_report(outs):
    """Phase 21's kernel check: every rank's rows bit-equal to the
    one-process product, one launch per product; returns per library
    and block the ranks' median device ms and the exchange's ms."""
    report = {}
    for rank, (prods, *_) in enumerate(outs):
        for p in prods:
            print(f"{p['library']} {p['name']} rank {rank} rows "
                  f"{p['rows']} carrier {p['carrier']}: {p['launches']} "
                  f"launch, max|rank - one process| {p['max_abs_diff']:.1e}"
                  f", bit-equal {p['equal']}; kernel {p['ms'] * 1e3:.1f} us"
                  f" (bound {p['bound_ms'] * 1e3:.1f} us) beside the "
                  f"one-process product's {p['one_ms'] * 1e3:.1f} us; "
                  f"halo exchange {p['exchange_ms']:.3f} ms on the host")
            if (p["max_abs_diff"] != 0.0 or not p["equal"]
                    or p["launches"] != 1):
                raise AssertionError(f"{p['library']} {p['name']} rank "
                                     f"{rank}: off the one-process product")
            report.setdefault((p["library"], p["name"]), []).append(p)
    return report


def lattice_ranked_phase(small_card, sharded_full, seam_work,
                         replicated_work):
    """Phase 21: the lattice layout on W ranks of the one card, held to
    phases 3, 4 and 7; each launch then runs phase 22's and phase 23's
    work for its W (`seam_work`, `replicated_work`: W -> the arguments of
    `_ranked_seam`, `_ranked_replicated`).  Returns the kernel check's
    records, the full-width run's per-rank dicts, per small case each
    rank's (sharded, unsharded) launches, and per W the ranks' phase-22
    outputs and their phase-23 outputs, each with the W = 4 launch's
    nvidia-smi samples."""
    worlds = {}
    launches = {}
    seam_outs = {}
    replicated_outs = {}
    for label, dim, W in LATTICE_SMALL:
        worlds.setdefault(W, []).append((label, dim))
    kernels = full = None
    for W, cases in sorted(worlds.items()):
        last = W == LATTICE_FULL_W
        samples = [] if last else None
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outs = _launch_on_card(_ranked_lattice, W,
                                   ([dim for _, dim in cases], last, last,
                                    seam_work.get(W),
                                    replicated_work.get(W)),
                                   tmp, samples)
        seam_outs[W] = [o[4] for o in outs]
        replicated_outs[W] = [o[5] for o in outs]
        infos = [o[2] for o in outs]
        print(f"phase 21 on cuda, {W} ranks ("
              + "; ".join(f"rank {i['rank']} on {i['device']}"
                          for i in infos)
              + f"), {infos[0]['transport']}: {time.perf_counter() - t0:.1f}"
              f" s with the ranks' start; peak device memory per rank "
              f"after the small cases {[i['peak_bytes'] for i in infos]} B")
        if last:
            kernels = _lattice_kernel_report(outs)
        for n, (label, dim) in enumerate(cases):
            ref = small_card[dim]
            run = outs[0][1][n]
            same = all(np.array_equal(o[1][n][1], run[1])
                       and o[1][n][2] == run[2] for o in outs)
            rel = float((np.abs(run[1] - ref[1]) / np.abs(ref[1])).max())
            bits = np.array_equal(run[1], ref[1]) and run[2] == ref[2]
            print(f"{label} on cuda: {run[3]:.1f} s, energies "
                  f"{run[1].tolist()}, Newton/linear its {run[2]} (phase 4:"
                  f" {ref[2]}), max rel difference to phase 4 {rel:.3e} "
                  f"(bound 1e-12), bit-equal to phase 4: {bits}, ranks "
                  f"bit-equal: {same}; (sharded, unsharded) launches per "
                  f"rank {[o[1][n][4] for o in outs]}")
            if (rel > 1e-12 or not same or run[0] != ref[0]
                    or [a for a, _ in run[2]] != [a for a, _ in ref[2]]):
                raise AssertionError(f"{label}: off phase 4's card run")
            launches[label] = [o[1][n][4] for o in outs]
        if last:
            full = [o[3] for o in outs]
            # the samples until phase 22's work began
            t22 = seam_outs[W][0]["t0"] if seam_outs[W][0] else math.inf
            _lattice_full_report(full, [x for x in samples if x[0] < t22],
                                 sharded_full)
    return (kernels, full, launches, (seam_outs, samples),
            (replicated_outs, samples))


def _lattice_full_report(outs, samples, ref):
    """Phase 21, full width: every rank's run against phase 7's sharded
    run, and what it cost."""
    W = len(outs)
    out = outs[0]
    label = f"2d main path lattice D={D_SHARDS} W={W}"
    for o in outs[1:]:
        if not (np.array_equal(o["energies"], out["energies"])
                and o["newton"] == out["newton"]):
            raise AssertionError(f"{label}: rank {o['rank']} differs from "
                                 "rank 0")
    rel = float(np.max(np.abs(out["energies"] - ref["energies"])
                       / np.abs(ref["energies"])))
    its = sum(p[1] for p in out["passes"])
    wall = sum(p[0] for p in out["passes"])
    ex, coll, nbytes = (sum(p[k] for p in out["passes"]) for k in (2, 3, 4))
    print(f"{label}: {out['secs']:.2f} s in rank 0's run, s per step "
          f"{[round(x, 3) for x in out['step_s']]}, Newton its "
          f"{out['newton']} (phase 7 {ref['newton']}), linear its "
          f"{out['linear']}, {out['n_split']} of {out['n_levels']} levels "
          f"split by slab, rows per rank {[o['rows'] for o in outs]}")
    print(f"{label}: {len(out['passes'])} CG passes, {its} CG iterations, "
          f"{1e3 * wall / max(its, 1):.2f} ms, {ex / max(its, 1):.1f} "
          f"exchanges, {coll / max(its, 1):.1f} collectives and "
          f"{nbytes / max(its, 1):.0f} B per CG iteration per rank (rank 0;"
          f" the passes' setup included)")
    print(f"{label}: peak device memory per rank "
          f"{[o['peak_bytes'] for o in outs]} B, sharded launches per rank "
          f"{[o['sharded'] for o in outs]} (phase 7: {ref['sharded']}), "
          f"unsharded per rank {[o['unsharded'] for o in outs]} (phase 7: "
          f"{ref['launches']}), of them phase-field per rank "
          f"{[o['phi'] for o in outs]} (phase 7: {ref['route_launches']}); "
          "energies "
          f"{[repr(float(e)) for e in out['energies'].ravel()]}, max rel "
          f"difference to phase 7 {rel:.3e} (bound 1e-10)")
    busy = [u for _, u in samples]
    print(f"{label}: idle share "
          + (f"{100 - sum(busy) / len(busy):.1f} % (nvidia-smi "
             f"utilization.gpu, {len(busy)} samples over phase 21's part "
             "of the launch)" if busy else "not measured (no sample)"))
    if (rel > 1e-10 or out["newton"] != ref["newton"] or out["cuts"]
            or out["steps"] != 2
            or any(o["sharded"] != ref["sharded"] for o in outs)):
        raise AssertionError(f"{label}: off phase 7's run")


# phase 22: the seam lattice on W ranks of the one card, run by phase
# 21's rank processes after their own work.  Small: (label, refinement,
# D = W); the one-process card runs at the same D are the references.
# Full width: phase 17's bench case at D = 4 on W = 4, the first
# SEAM_RANKED_STEPS of the 3 load steps of phase 17's D = 4 run (the
# smoke's time limit: a proof run of all 3 took 1,327 s in all, its W
# rank phases far slower than the runs before, PERF.md)
SEAM_RANKED_SMALL = [("miehe_shear_2 refine 4 D=2 W=2", 4, 2),
                     ("miehe_shear_2 refine 4 D=4 W=4", 4, 4),
                     ("miehe_shear_2 refine 5 D=2 W=2", 5, 2)]
SEAM_RANKED_W = 4
SEAM_RANKED_STEPS = 1


def _seam_case(refine, D, device):
    """A small phase-22 case, `_run_case`'s tuple with the
    (sharded, unsharded 2d, phase-field) launches and the seam's
    exchanges of the run."""
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.parallel import dist
    _zero_stencil_counts()
    dist.reset_counts()
    run = _run_case("miehe", refine, dict(n_devices=D,
                                          dof_sharding="lattice"), device)
    return run + ((stencil.stencil_matvec_sharded.launches,
                   stencil.stencil_matvec2d.launches,
                   stencil.stencil_matvec2d.phi_launches),
                  dist.EXCHANGES["seam"])


def _ranked_seam_full(ranks, refine, steps):
    """A rank of phase 22's full-width run: the bench case on the ranks,
    every CG pass timed between synchronizations with its exchanges
    (the seam's apart), collectives and bytes counted, and the launches
    per load step."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.parallel import dist
    from cracks_tpu_torch.solvers import lattice
    if ranks.rank:
        sys.stdout = open(os.devnull, "w")
    cuda = ranks.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    real = lattice._cg_pass32
    passes = []

    def timed(*args, **kw):
        sync()
        e0, c0 = dict(dist.EXCHANGES), dict(dist.COUNTS)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync()
        passes.append((time.perf_counter() - t0, out[1],
                       dist.EXCHANGES["exchanges"] - e0["exchanges"],
                       dist.EXCHANGES["seam"] - e0["seam"],
                       dist.COUNTS["collectives"] - c0["collectives"],
                       dist.EXCHANGES["bytes"] - e0["bytes"]
                       + dist.COUNTS["bytes"] - c0["bytes"]))
        return out

    t0 = time.perf_counter()
    sim = Simulation(_miehe_params(refine, steps, n_devices=ranks.world,
                                   dof_sharding="lattice"),
                     device=ranks.device.type, verbose=False)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    host_s = time.perf_counter() - t0
    _zero_stencil_counts()
    dist.reset_counts()
    per_step, undo = _launches_per_step()
    lattice._cg_pass32 = timed
    t0, w0 = time.perf_counter(), time.time()
    try:
        sim.run()
    finally:
        lattice._cg_pass32 = real
        undo()
    sync()
    window = (w0, time.time())
    hier = sim.sys.lattice_hierarchy
    return dict(stats=np.array([sim.statistics.data[c]
                                for c in MIEHE_COLUMNS], dtype=float),
                newton=[e[1] for e in sim.solver_effort],
                linear=[e[2] for e in sim.solver_effort],
                steps=len(sim.solver_effort), cuts=sim.step_cuts,
                step_s=[t for _, _, t in sim.step_times],
                secs=time.perf_counter() - t0, host_s=host_s,
                per_step=per_step,
                phi=stencil.stencil_matvec2d.phi_launches,
                seam=tuple(hier.seam), n_split=hier.n_split,
                n_levels=hier.n_levels, dofs=sim.mesh.n_dofs,
                rows=(hier.slabs[-1].a, hier.slabs[-1].b), passes=passes,
                window=window, **_rank_info(ranks))


def _ranked_seam(ranks, cases, full):
    """A rank's phase-22 work: each small case's `_seam_case` tuple
    (cases: refinements, at D = W), the rank's device, transport and
    peak memory after them, then with `full` (refinement, steps) the
    full-width run; with its start and end on the host's clock.  The
    peak memory counter starts anew (phase 21 ran in the process)."""
    t0 = time.time()
    if ranks.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    small = [_seam_case(refine, ranks.world, ranks.device.type)
             for refine in cases]
    info = _rank_info(ranks)
    full = None if full is None else _ranked_seam_full(ranks, *full)
    return dict(small=small, info=info, full=full, t0=t0, t1=time.time())


def _seam_small_report(label, outs, n, ref):
    """Phase 22, small: every rank's case n bit-equal to the
    one-process card run `ref` at the same D, with equal Newton
    iterations; the straddle at D = 2 made seam exchanges."""
    outs = [o["small"] for o in outs]
    run = outs[0][n]
    same = all(np.array_equal(o[n][1], run[1]) and o[n][2] == run[2]
               for o in outs)
    bits = np.array_equal(run[1], ref[1])
    rel = float((np.abs(run[1] - ref[1]) / np.abs(ref[1])).max())
    print(f"{label} on cuda: {run[0]} DoFs, {run[4]:.1f} s in rank 0, "
          f"statistics {run[1].tolist()}, Newton/linear its {run[2]} "
          f"(one process: {ref[2]}, {ref[4]:.1f} s), bit-equal to the "
          f"one-process run: {bits} (max rel {rel:.3e}), ranks bit-equal: "
          f"{same}; (sharded, 2d, phase-field) launches per rank "
          f"{[o[n][5] for o in outs]} (one process {ref[5]}), seam "
          f"exchanges per rank {[o[n][6] for o in outs]}")
    if (not bits or not same or run[2] != ref[2] or run[3]
            or run[0] != ref[0]
            or any(min(o[n][5]) <= 0 for o in outs)):
        raise AssertionError(f"{label}: off the one-process card run")


def seam_refs_phase():
    """Phase 22's references: each small case's one-process card run at
    its D, before the ranks start."""
    return {(refine, W): _seam_case(refine, W, "cuda")
            for _, refine, W in SEAM_RANKED_SMALL}


def seam_work():
    """Phase 22's work for each W: `_ranked_seam`'s arguments, run by
    phase 21's launch of that W."""
    work = {}
    for _, refine, W in SEAM_RANKED_SMALL:
        work.setdefault(W, [[], None])[0].append(refine)
    work[SEAM_RANKED_W][1] = (MIEHE_FULL["refine"], SEAM_RANKED_STEPS)
    return {W: tuple(w) for W, w in work.items()}


def seam_ranked_phase(seam, refs, ranked):
    """Phase 22: the seam lattice on W ranks of the one card, held to
    one-process card runs (`refs`, `seam_refs_phase`) and to phase 17's
    D = 4 bench run (`seam`: phase 17's dict); `ranked`: per W the
    ranks' outputs of phase 21's launches and the W = 4 launch's
    nvidia-smi samples.  Returns the full-width run's per-rank dicts."""
    outs_by_w, samples = ranked
    cases = {}
    for label, refine, W in SEAM_RANKED_SMALL:
        cases.setdefault(W, []).append((label, refine))
    full = None
    for W, outs in sorted(outs_by_w.items()):
        infos = [o["info"] for o in outs]
        print(f"phase 22 on cuda, {W} ranks ("
              + "; ".join(f"rank {i['rank']} on {i['device']}"
                          for i in infos)
              + f"), {infos[0]['transport']}: "
              f"{outs[0]['t1'] - outs[0]['t0']:.1f} s in rank 0 (after "
              f"phase 21 in the same processes); peak device memory per "
              f"rank after the small cases {[i['peak_bytes'] for i in infos]}"
              " B")
        for n, (label, refine) in enumerate(cases[W]):
            _seam_small_report(label, outs, n, refs[(refine, W)])
        if W == SEAM_RANKED_W:
            full = [o["full"] for o in outs]
            w0, w1 = full[0]["window"]
            _seam_full_report(full, [x for x in samples
                                     if w0 <= x[0] <= w1], seam)
    return full


def _seam_full_report(outs, samples, ref):
    """Phase 22, full width: every rank's run against phase 17's D = 4
    run (`ref`: phase 17's dict), and what it cost."""
    W = len(outs)
    out = outs[0]
    n = out["steps"]
    label = f"miehe_shear bench case D={W} W={W}"
    for o in outs[1:]:
        if not (np.array_equal(o["stats"], out["stats"])
                and o["newton"] == out["newton"]):
            raise AssertionError(f"{label}: rank {o['rank']} differs from "
                                 "rank 0")
    want = ref["sharded_stats"][:, :n]
    rel = float(np.max(np.abs(out["stats"] - want) / np.abs(want)))
    its = sum(p[1] for p in out["passes"])
    wall = sum(p[0] for p in out["passes"])
    ex, seam_ex, coll, nbytes = (sum(p[k] for p in out["passes"])
                                 for k in (2, 3, 4, 5))
    per = lambda x: x / max(its, 1)
    print(f"{label}: {out['dofs']} DoFs, seam {out['seam']}, "
          f"{out['n_split']} of {out['n_levels']} levels split by slab, "
          f"rows per rank {[o['rows'] for o in outs]}; {out['secs']:.2f} s "
          f"in rank 0's run (host setup {out['host_s']:.2f} s), s per step "
          f"{[round(x, 3) for x in out['step_s']]}, Newton its "
          f"{out['newton']} (phase 17 D=4: {ref['sharded_newton'][:n]}), "
          f"linear its {out['linear']}")
    print(f"{label}: {len(out['passes'])} CG passes, {its} CG iterations, "
          f"{1e3 * per(wall):.2f} ms, {per(ex):.1f} exchanges (of them "
          f"{per(seam_ex):.2f} the seam's), {per(coll):.1f} collectives "
          f"and {per(nbytes):.0f} B per CG iteration per rank (rank 0; the "
          f"passes' setup included)")
    print(f"{label}: peak device memory per rank "
          f"{[o['peak_bytes'] for o in outs]} B; (sharded, 2d) launches "
          f"per step per rank {[o['per_step'] for o in outs]} (phase 17 "
          f"D=4: {ref['sharded_per_step'][:n]}), phase-field launches per "
          f"rank {[o['phi'] for o in outs]}; statistics "
          f"{[repr(float(e)) for e in out['stats'].ravel()]}, max rel "
          f"difference to phase 17's D=4 run {rel:.3e} (bound 1e-10)")
    busy = [u for _, u in samples]
    print(f"{label}: idle share "
          + (f"{100 - sum(busy) / len(busy):.1f} % (nvidia-smi "
             f"utilization.gpu, {len(busy)} samples over the run)"
             if busy else "not measured (no sample)"))
    if (rel > 1e-10 or out["newton"] != ref["sharded_newton"][:n]
            or out["cuts"] or n != SEAM_RANKED_STEPS
            or any(o["per_step"] != ref["sharded_per_step"][:n]
                   for o in outs)
            or any(o["phi"] <= 0 or o["per_step"][-1][1] <= 0
                   for o in outs)):
        raise AssertionError(f"{label}: off phase 17's D=4 run")


# phase 23: the replicated cell-axis mode on W ranks of the one card
# (n_devices = D, replicated DoF vectors: each rank computes its range of
# the cells and gathers every rank's per-cell terms; the lattice solve on
# the ranks' row slabs), run by phase 21's rank processes after phase
# 22's work.  Small: (label, .prm, overrides, W = D, its golden table
# and the golden's column overrides or None); the one-process card runs
# at the same D are the references (`replicated_refs_phase`).  Full
# width: phase 5's 2d bench case, replicated, at D = W =
# REPLICATED_FULL_W, load step 0, against phase 5's run
REPLICATED_SMALL = [
    ("sneddon_3d_1 D=4 W=4", os.path.join(PRM_TESTS, "sneddon_3d_1.prm"),
     dict(output_dir="", n_devices=4), 4,
     ("sneddon_3d_1.mpirun=4.statistics", None)),
    ("threepoint_1 D=2 W=2", os.path.join(PRM_TESTS, "threepoint_1.prm"),
     dict(output_dir="", n_devices=2), 2,
     ("threepoint_1.mpirun=2.statistics", {"Load": (1e-6, 5e-5)})),
    ("miehe_shear_1 simple monolithic matrix-free D=2 W=2",
     MIEHE_SHEAR_1_PRM,
     dict(MATRIX_FREE, output_dir="", max_no_timesteps=2,
          outer_solver="simple monolithic", n_devices=2), 2, None),
    # the Galerkin GMG's split solve: the fine level split by range, the
    # coarse chain built on every rank; load step 0 against the golden's
    # first row at phase 14's tolerance
    ("hetero_3d_1 Galerkin split solve D=4 W=4", HETERO_PRM,
     dict(HETERO_MIXED, output_dir="", max_no_timesteps=0, n_devices=4), 4,
     ("hetero_3d_1.mpirun-4.statistics", {"Energy": (1e-6, 3e-3)})),
]
REPLICATED_FULL_W = 4


def _replicated_case(prm, overrides):
    """One phase-23 case on this process's device (the ranks', if any):
    (DoFs, (column names, statistics table), (Newton, linear) its per
    solve, time-step cuts, seconds, cell gathers and their bytes, whether
    the cells were split)."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.parallel import dist
    dist.reset_counts()
    t0 = time.perf_counter()
    sim = Simulation(config.load_parameters(prm, **overrides),
                     device="cuda", verbose=False)
    sim.run()
    torch.cuda.synchronize()
    return (sim.mesh.n_dofs, parse_statistics(sim.statistics.write_text()),
            [(e[1], e[2]) for e in sim.solver_effort], sim.step_cuts,
            time.perf_counter() - t0, dict(dist.CELL_GATHERS),
            sim.sys.cells is not None)


def replicated_refs_phase():
    """Phase 23's references: each small case's one-process card run at
    its D, before the ranks start."""
    return {label: _replicated_case(prm, ov)
            for label, prm, ov, _, _ in REPLICATED_SMALL}


def _ranked_replicated_full(ranks):
    """A rank of phase 23's full-width run: phase 5's 2d case at D = W,
    replicated, load step 0, with every CG pass timed between
    synchronizations and the cell gathers, exchanges, collectives and
    bytes of the step and of its passes counted."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import stencil
    from cracks_tpu_torch.parallel import dist
    from cracks_tpu_torch.solvers import lattice
    if ranks.rank:
        sys.stdout = open(os.devnull, "w")
    real = lattice._cg_pass32
    passes = []

    def counts():
        return (dist.CELL_GATHERS["gathers"], dist.EXCHANGES["exchanges"],
                dist.COUNTS["collectives"],
                dist.EXCHANGES["bytes"] + dist.COUNTS["bytes"])

    def timed(*args, **kw):
        torch.cuda.synchronize()
        c0 = counts()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0, out[1])
                      + tuple(b - a for a, b in zip(c0, counts())))
        return out

    sim = Simulation(_params(2, FULL[2][0], max_no_timesteps=0,
                             n_devices=ranks.world),
                     device="cuda", verbose=False)
    _fresh_memory_baseline()
    _zero_stencil_counts()
    dist.reset_counts()
    lattice._cg_pass32 = timed
    t0, w0 = time.perf_counter(), time.time()
    try:
        sim.run()
    finally:
        lattice._cg_pass32 = real
    torch.cuda.synchronize()
    hier = sim.sys.lattice_hierarchy
    cells = sim.sys.cells
    return dict(energies=_energies(sim),
                newton=[e[1] for e in sim.solver_effort],
                linear=[e[2] for e in sim.solver_effort],
                steps=len(sim.solver_effort), cuts=sim.step_cuts,
                step_s=[t for _, _, t in sim.step_times],
                secs=time.perf_counter() - t0, window=(w0, time.time()),
                cell_gathers=dict(dist.CELL_GATHERS),
                collectives=dist.COUNTS["collectives"],
                exchanges=dist.EXCHANGES["exchanges"],
                bytes=dist.COUNTS["bytes"] + dist.EXCHANGES["bytes"],
                sharded=stencil.stencil_matvec_sharded.launches,
                unsharded=stencil.stencil_matvec2d.launches,
                phi=stencil.stencil_matvec2d.phi_launches,
                cells=(cells.lo, cells.hi), n_split=hier.n_split,
                n_levels=hier.n_levels,
                rows=(hier.slabs[-1].a, hier.slabs[-1].b), passes=passes,
                peak_bytes=torch.cuda.max_memory_allocated(),
                **{k: v for k, v in _rank_info(ranks).items()
                   if k != "peak_bytes"})


def _ranked_replicated(ranks, labels, full):
    """A rank's phase-23 work: each small case's `_replicated_case`
    tuple, the rank's device, transport and peak memory after them, then
    with `full` the full-width run; with its start and end on the
    host's clock.  The peak memory counter starts anew."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cases = {label: (prm, ov) for label, prm, ov, _, _ in REPLICATED_SMALL}
    small = [_replicated_case(*cases[label]) for label in labels]
    info = _rank_info(ranks)
    full = _ranked_replicated_full(ranks) if full else None
    return dict(small=small, info=info, full=full, t0=t0, t1=time.time())


def replicated_work():
    """Phase 23's work for each W: `_ranked_replicated`'s arguments, run
    by phase 21's launch of that W after phase 22's work."""
    work = {}
    for label, _, _, W, _ in REPLICATED_SMALL:
        work.setdefault(W, [[], False])[0].append(label)
    work.setdefault(REPLICATED_FULL_W, [[], False])[1] = True
    return {W: tuple(w) for W, w in work.items()}


def _replicated_small_report(label, outs, n, ref, golden):
    """Phase 23, small: every rank's case n bit-equal to the one-process
    card run `ref` at the same D (statistics, Newton and linear
    iterations), the cells split; with `golden` (table, column
    overrides) the table within the golden's first rows' tolerance:
    phase 12's or 14's overrides, or without them phase 9's rule on the
    golden's columns."""
    runs = [o["small"][n] for o in outs]
    run = runs[0]
    (names, ours), (_, theirs) = run[1], ref[1]
    bits = (all(np.array_equal(r[1][1], ours, equal_nan=True)
                and r[2] == run[2] for r in runs)
            and np.array_equal(ours, theirs, equal_nan=True)
            and run[2] == ref[2])
    fails = []
    if golden is not None:
        with open(os.path.join(GOLDEN_DIR, golden[0])) as f:
            g_names, g_table = parse_statistics(f.read())
        g_table = g_table[:len(ours)]
        if golden[1] is not None:
            fails = golden_failures(names, ours, g_names, g_table,
                                    golden[1], None, {})
        elif names[:len(g_names)] != g_names:
            fails = [f"columns {names} vs {g_names}"]
        else:
            fails = table_failures(ours[:, :len(g_names)], g_table, 1e-6,
                                   1e-8)
    gathers = run[5]
    print(f"{label} on cuda: {run[0]} DoFs, {run[4]:.1f} s in rank 0 "
          f"(one process {ref[4]:.1f} s), Newton/linear its per solve "
          f"{run[2]}, {gathers['gathers']} cell gathers of "
          f"{gathers['bytes']} B per rank, cells split on every rank: "
          f"{all(r[6] for r in runs)}, every rank bit-equal to the "
          f"one-process card run: {bits}"
          + ("" if golden is None else
             f", {len(fails)} cells off {golden[0]}"))
    if (not bits or fails or run[3] or not all(r[6] for r in runs)
            or ref[6]):
        raise AssertionError(f"{label}: off the one-process card run or "
                             "its golden:\n" + "\n".join(fails[:20]))


def _replicated_full_report(outs, samples, ref):
    """Phase 23, full width: every rank's run against phase 5's
    replicated run's load step 0 (`ref`: main_phase's dict), and what it
    cost."""
    W = len(outs)
    out = outs[0]
    label = f"2d main path replicated D={W} W={W}"
    for o in outs[1:]:
        if not (np.array_equal(o["energies"], out["energies"])
                and o["newton"] == out["newton"]):
            raise AssertionError(f"{label}: rank {o['rank']} differs from "
                                 "rank 0")
    want = ref["energies"][:, :1]
    rel = float(np.max(np.abs(out["energies"] - want) / np.abs(want)))
    newton = sum(out["newton"])
    its = sum(p[1] for p in out["passes"])
    wall = sum(p[0] for p in out["passes"])
    cg_gathers, ex, coll, nbytes = (sum(p[k] for p in out["passes"])
                                    for k in (2, 3, 4, 5))
    per_it = lambda x: x / max(its, 1)
    per_newton = lambda x: x / max(newton, 1)
    g = out["cell_gathers"]
    print(f"{label}: {out['secs']:.2f} s in rank 0's run, s per step "
          f"{[round(x, 3) for x in out['step_s']]} (phase 5 "
          f"{[round(x, 3) for x in ref['step_s'][:1]]}), Newton its "
          f"{out['newton']} (phase 5 {ref['newton'][:1]}), linear its "
          f"{out['linear']}; cells per rank {[o['cells'] for o in outs]}, "
          f"{out['n_split']} of {out['n_levels']} GMG levels split by "
          f"slab, rows per rank {[o['rows'] for o in outs]}; "
          + "; ".join(f"rank {o['rank']} on {o['device']}" for o in outs)
          + f", {out['transport']}")
    print(f"{label}: per Newton iteration "
          f"{1e3 * per_newton(sum(out['step_s'])):.1f} ms (the step's "
          f"time over its Newton iterations), "
          f"{per_newton(g['gathers']):.1f} cell gathers of "
          f"{per_newton(g['bytes']):.0f} B, "
          f"{per_newton(out['collectives']):.1f} collectives, "
          f"{per_newton(out['exchanges']):.1f} exchanges and "
          f"{per_newton(out['bytes']):.0f} B per rank (rank 0); "
          f"{len(out['passes'])} CG passes, {its} CG iterations, "
          f"{1e3 * per_it(wall):.2f} ms, {per_it(cg_gathers):.2f} cell "
          f"gathers, {per_it(ex):.1f} exchanges, {per_it(coll):.1f} "
          f"collectives and {per_it(nbytes):.0f} B per CG iteration per "
          f"rank (the passes' setup included)")
    print(f"{label}: peak device memory per rank "
          f"{[o['peak_bytes'] for o in outs]} B (the one-process run, "
          f"phase 5: {ref['peak_bytes']} B); launches per rank: sharded "
          f"{[o['sharded'] for o in outs]}, unsharded 2d "
          f"{[o['unsharded'] for o in outs]}, of them phase-field "
          f"{[o['phi'] for o in outs]}; energies "
          f"{[repr(float(e)) for e in out['energies'].ravel()]}, max rel "
          f"difference to phase 5's load step 0 {rel:.3e} (bound 1e-10)")
    w0, w1 = out["window"]
    busy = [u for t, u in samples if w0 <= t <= w1]
    print(f"{label}: idle share "
          + (f"{100 - sum(busy) / len(busy):.1f} % (nvidia-smi "
             f"utilization.gpu, {len(busy)} samples over the run)"
             if busy else "not measured (no sample)"))
    if (rel > 1e-10 or out["newton"] != ref["newton"][:1] or out["cuts"]
            or out["steps"] != 1 or g["gathers"] <= 0
            or any(o["sharded"] <= 0 or o["phi"] <= 0
                   or o["unsharded"] <= o["phi"] for o in outs)):
        raise AssertionError(f"{label}: off phase 5's run")


def replicated_ranked_phase(refs, ranked, main_ref, golden3d):
    """Phase 23: the replicated cell-axis mode on W ranks of the one
    card, held to one-process card runs (`refs`, whose sneddon_3d_1 run
    at D = 4 must be phase 9's `golden3d` table bit for bit) and to phase
    5's replicated run (`main_ref`); `ranked`: per W the ranks' outputs
    of phase 21's launches and the W = 4 launch's nvidia-smi samples.
    Returns the full-width run's per-rank dicts."""
    outs_by_w, samples = ranked
    label3d = REPLICATED_SMALL[0][0]
    same3d = np.array_equal(refs[label3d][1][1], golden3d, equal_nan=True)
    print(f"{label3d}: the one-process card run at n_devices = 4 bit-equal "
          f"to phase 9's at n_devices = 1: {same3d}")
    if not same3d:
        raise AssertionError(f"{label3d}: n_devices = 4 in one process is "
                             "not phase 9's run")
    cases = {}
    for label, _, _, W, golden in REPLICATED_SMALL:
        cases.setdefault(W, []).append((label, golden))
    full = None
    for W, outs in sorted(outs_by_w.items()):
        infos = [o["info"] for o in outs]
        print(f"phase 23 on cuda, {W} ranks ("
              + "; ".join(f"rank {i['rank']} on {i['device']}"
                          for i in infos)
              + f"), {infos[0]['transport']}: "
              f"{outs[0]['t1'] - outs[0]['t0']:.1f} s in rank 0 (after "
              f"phases 21 and 22 in the same processes); peak device "
              f"memory per rank after the small cases "
              f"{[i['peak_bytes'] for i in infos]} B")
        for n, (label, golden) in enumerate(cases.get(W, [])):
            _replicated_small_report(label, outs, n, refs[label], golden)
        if W == REPLICATED_FULL_W:
            full = [o["full"] for o in outs]
            _replicated_full_report(full, samples, main_ref)
    return full


def _main_paths():
    """The main path of each dimension at full width, replicated and
    then sharded: ({dim: main_phase's dict}, the same sharded)."""
    full = {k["dim"]: _timed(main_phase, k["dim"]) for k in KERNELS}
    return full, {dim: main_phase(dim, replicated=full[dim], **SHARDED)
                  for dim in full}


def _timed(phase, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    device_phase()
    _timed(build_phase)
    records = {k["name"]: _timed(kernel_phase, k) for k in KERNELS}
    (full, full_sharded), small_card = _timed(small_phases, _main_paths)
    print(f"main_phase, sharded: {time.perf_counter() - t_start:.1f} s "
          "since the start")
    _timed(golden2d_phase)
    golden3d = _timed(golden3d_phase)
    _timed(shipped_phase)
    jacobi = _timed(production_phase)
    # the CPU references of phases 14, 17 and 18 start a phase ahead of
    # them, beside the card's phases 12-13, 16 and 17 (they were what
    # 14, 17 and 18 waited for)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            1 + len(SEAM_JOBS) + len(MF_SMALL), mp_context=ctx) as early:
        hetero_cpu = early.submit(_run_hetero_cpu, HETERO_MIXED, 4)
        for phase in (goldens_phase, shipped_miehe_phase,
                      shipped_tension_phase):
            _timed(phase)
        _timed(hetero_goldens_phase, hetero_cpu)
        _timed(hetero3d_phase)
        seam_cpu = [early.submit(_run_case, kind, r, {}, "cpu", 1)
                    for kind, r, _ in SEAM_JOBS]
        _timed(production_gmg_phase, jacobi)
        mf_cpu = mf_cpu_jobs(early)
        seam = _timed(seam_phase, seam_cpu)
        _timed(matrix_free_phase, mf_cpu)
    multi = _timed(sharded_modes_phase, jacobi)
    _timed(ranked_phase, multi)
    # phase 22's and 23's references, then phase 21, whose launches run
    # phase 22's and 23's work after their own
    seam_refs = _timed(seam_refs_phase)
    replicated_refs = _timed(replicated_refs_phase)
    (lattice_kernels, lattice_full, lattice_small, seam_ranked,
     replicated_ranked) = _timed(lattice_ranked_phase, small_card,
                                 full_sharded[2], seam_work(),
                                 replicated_work())
    seam_full = _timed(seam_ranked_phase, seam, seam_refs, seam_ranked)
    replicated_full = _timed(replicated_ranked_phase, replicated_refs,
                             replicated_ranked, full[2], golden3d)
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
        if k["dim"] == 2:
            entries[-1]["launches_seam"] = seam["phi_launches"]
            entries[-1]["launches_seam_ranked"] = [o["phi"]
                                                   for o in seam_full]
            entries[-1]["launches_multi_shard"] = multi["phi"]
            entries[-1]["launches_replicated_ranked"] = [
                o["phi"] for o in replicated_full]
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
        if k["dim"] == 2:
            entries[-1]["launches_seam"] = (seam["launches"]
                                            - seam["phi_launches"])
            entries[-1]["launches_seam_ranked"] = [
                o["per_step"][-1][1] - o["phi"] for o in seam_full]
            entries[-1]["seam_products"] = seam["products"]
            entries[-1]["launches_multi_shard"] = multi["rest"]
            entries[-1]["launches_replicated_ranked"] = [
                o["unsharded"] - o["phi"] for o in replicated_full]
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
        if k["dim"] == 2:
            entries[-1]["launches_seam"] = seam["sharded"]
            entries[-1]["launches_multi_shard"] = multi["sharded"]
            entries[-1]["launches_ranked"] = [o["sharded"]
                                              for o in lattice_full]
            entries[-1]["launches_seam_ranked"] = [o["per_step"][-1][0]
                                                   for o in seam_full]
            entries[-1]["launches_replicated_ranked"] = [
                o["sharded"] for o in replicated_full]
        else:
            entries[-1]["launches_ranked"] = [
                sharded for sharded, _ in lattice_small[LATTICE_SMALL[-1][0]]]
        entries[-1]["ranked"] = [
            dict(name=p["name"], rank=r, rows=p["rows"], ms=p["ms"],
                 one_process_ms=p["one_ms"], exchange_ms=p["exchange_ms"],
                 bound_ms=p["bound_ms"], max_abs_diff=p["max_abs_diff"])
            for (lib, _), ps in lattice_kernels.items() if lib == k["sharded"]
            for r, p in enumerate(ps)]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
