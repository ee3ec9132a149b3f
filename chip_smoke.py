"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
without printing the final line:

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and the torch/CUDA versions;
2. build: compiles the lattice-stencil kernel from
   cracks_tpu_torch/csrc/ with nvcc (timed);
3. kernel vs plain: the kernel against its plain PyTorch version on the
   card, at the refine-6 Sneddon shapes (640x640 cells) of the four
   stencil products the solve runs, from seeded numpy inputs; both
   timed with CUDA events (median of 25 runs, L2 flushed before each);
4. main path, small: the port's Simulation at refine 3 on the card and
   on the CPU (plain versions); the energies must agree;
5. main path, full size: the Sneddon 2d bench case (refine 6,
   1,232,643 DoFs, two load steps, lattice GMG mixed-precision CG) on
   the card; every step must converge with finite statistics, and the
   kernel's launch count must rise during the run.

The line before the last is a JSON object with the kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
GC = 640          # refine-6 Sneddon cell grid per axis (641 vertices)
REFINE = 6
N_DOFS = 1_232_643
PRM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params",
                   "parameters_sneddon_2d.prm")
# (name, dtype, lo_r, hi_r, lo_c, hi_c, k_in, k_out): the u block and the
# phase-field block of the f32 CG pass / V-cycle, and the f64 u block and
# J_pu coupling block of the refinement residual
SHAPES = [
    ("f32 u block", torch.float32, 0, 8, 0, 8, 2, 2),
    ("f32 phi block", torch.float32, 8, 12, 8, 12, 1, 1),
    ("f64 u block", torch.float64, 0, 8, 0, 8, 2, 2),
    ("f64 J_pu block", torch.float64, 8, 12, 0, 8, 2, 1),
]
# f32: the bounds of tests/test_pallas_stencil.py; f64: rounding-level
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-12)}


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
    t0 = time.perf_counter()
    path, log = kernels.build("lattice_stencil")
    kernels.lattice_stencil()
    print(f"build: {path} in {time.perf_counter() - t0:.2f} s")
    if log.strip():
        print(log.strip())


def _time_ms(fn, flush, reps=25, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase():
    """Kernel vs plain at the refine-6 shapes; returns one record per
    shape."""
    from cracks_tpu_torch.ops.stencil import (stencil_matvec,
                                              stencil_matvec_reference)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    jac64 = torch.as_tensor(rng.standard_normal((12, 12, GC, GC)),
                            dtype=torch.float64, device=dev)
    x64 = torch.as_tensor(rng.standard_normal((2, GC + 1, GC + 1)),
                          dtype=torch.float64, device=dev)
    flush = torch.empty(2 ** 27, dtype=torch.uint8, device=dev)  # 128 MB
    records = []
    for name, dt, lo_r, hi_r, lo_c, hi_c, k_in, k_out in SHAPES:
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
        bound = atol_rel * scale + rtol * y_ref.abs()
        if not bool((err <= bound).all()) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 f"version, max |err| {max_abs_err:.3e}, "
                                 f"max |Y| {scale:.3e}")
        ms = _time_ms(lambda: stencil_matvec(jac, X, *args), flush)
        plain_ms = _time_ms(lambda: stencil_matvec_reference(jac, X, *args),
                            flush)
        jbytes = (hi_r - lo_r) * (hi_c - lo_c) * GC * GC * jac.element_size()
        print(f"kernel {name}: k_in={k_in} k_out={k_out} "
              f"max|err|={max_abs_err:.3e} (max|Y| {scale:.3e}, rtol "
              f"{rtol:g}, atol {atol_rel:g}*max|Y|); kernel "
              f"{ms * 1e3:.1f} us = {jbytes / ms / 1e6:.1f} GB/s of J "
              f"({jbytes / 1e6:.1f} MB); plain {plain_ms * 1e3:.1f} us")
        records.append(dict(name=name, k_in=k_in, k_out=k_out,
                            dtype=str(dt).replace("torch.", ""),
                            max_abs_err=max_abs_err, ms=ms,
                            plain_ms=plain_ms, j_mb=jbytes / 1e6,
                            gbps=jbytes / ms / 1e6))
        del jac, X, y, y_ref, err, bound
    del jac64, x64, flush
    torch.cuda.empty_cache()
    return records


def _params(refine):
    from cracks_tpu_torch.host import config
    return config.load_parameters(
        PRM, n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
        cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)


def _energies(sim):
    d = sim.statistics.data
    return np.array([d["Bulk Energy"], d["Crack Energy"]], dtype=float)


def small_phase():
    """Refine 3 on the card vs the plain versions on the CPU."""
    from cracks_tpu_torch.driver import Simulation
    runs = {}
    for dev in ("cuda", "cpu"):
        sim = Simulation(_params(3), device=dev, verbose=False)
        sim.run()
        runs[dev] = sim
        print(f"refine 3 on {dev}: Newton/linear its per step "
              f"{[(e[1], e[2]) for e in sim.solver_effort]}, energies "
              f"{_energies(sim).tolist()}")
    a, b = _energies(runs["cuda"]), _energies(runs["cpu"])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"refine 3 cuda vs cpu: max relative energy difference "
          f"{rel:.3e} (bound 1e-7)")
    if not rel <= 1e-7:
        raise AssertionError("card and CPU runs disagree at refine 3")


def main_phase():
    """The bench case at full size; returns the kernel launch count."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops.stencil import stencil_matvec
    sim = Simulation(_params(REFINE), device="cuda", verbose=True)
    if sim.mesh.n_dofs != N_DOFS:
        raise AssertionError(f"{sim.mesh.n_dofs} DoFs, expected {N_DOFS}")
    torch.cuda.reset_peak_memory_stats()
    stencil_matvec.launches = 0
    sim.run()
    launches = stencil_matvec.launches
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
        raise AssertionError("the main path never launched the kernel")
    for (step, newton_its, lin_its, n_active), (_, _, secs) in zip(
            sim.solver_effort, sim.step_times):
        print(f"step {step}: {secs:.2f} s, {newton_its} Newton its, "
              f"{lin_its} linear its, active set {n_active}")
    print(f"main path: {sim.mesh.n_dofs} DoFs, kernel launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated()} B")
    return launches


def main():
    device_phase()
    build_phase()
    records = kernel_phase()
    small_phase()
    launches = main_phase()
    head = records[0]   # the f32 u block: the dominant product
    print(json.dumps({"kernels": [{
        "name": "lattice_stencil", "route": "cuda",
        "source": "cracks_tpu_torch/csrc/lattice_stencil.cu",
        "replaces": "cracks_tpu/ops/pallas_stencil.py:39",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "shapes": records}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
