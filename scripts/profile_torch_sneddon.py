"""Where the time goes in the PyTorch port's Sneddon lattice path on one
CUDA card, in 2d or 3d.

    python3 scripts/profile_torch_sneddon.py [dim [refine [shards]]]

dim is 2 (default; refine defaults to 6 = 1,232,643 DoFs) or 3 (refine
defaults to 3 = 2,125,764 DoFs); shards > 0 runs the lattice-layout
sharded Newton (n_devices = shards, dof_sharding = lattice) in place of
the replicated one.  Runs the case (two load steps, lattice GMG
mixed-precision CG) three times on the card, after timing
the host setup (forest refinement and mesh extraction, then the
system's setup: lattice detection, cell geometry, lumped mass, GMG
hierarchy) on its own:

1. warm-up (kernel build, cuBLAS/cuSOLVER initialisation);
2. phase timing: the solver's phases are wrapped with a synchronize on
   both sides and a host clock, which gives wall time per phase (the
   synchronizes add a little time of their own), and with a reset of
   the peak-memory counter, which gives each phase's peak device
   memory;
3. torch.profiler trace without the phase wrappers: device time by
   kernel name, the union of device-busy intervals against the wall
   time of the run (the device's idle share), the launches and time of
   every stencil kernel variant (dtype, k_in, k_out), and the stencil
   launches by product and GMG level: the unsharded wrapper's launches
   are logged (dimension, dtype, k_in, k_out, cell grid) by a wrapper
   around ``ops.stencil._launch``, the sharded product's by one around
   the lattice solve's ``stencil_matvec_sharded``, and the i-th logged
   unsharded launch is paired with the i-th stencil kernel on the
   device (one stream, in order) for its device time; the median device
   time per launch of each product at each level is printed, the
   finest f32 phase-field product's on a line of its own.

Prints the card's name and power limit first; writes the profiler's
table to chiprun_out/profile_torch_sneddon{dim}d[_sharded{D}].txt.
"""

import collections
import functools
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cracks_tpu_torch.driver import Simulation  # noqa: E402
from cracks_tpu_torch import config  # noqa: E402
from cracks_tpu_torch.ops import stencil  # noqa: E402
from cracks_tpu_torch.solvers import (lattice, lattice_newton,  # noqa: E402
                                      newton)

PHASES = [
    (newton, "_assemble", "residual assembly (f64)"),
    (newton, "_active_set_update", "PDAS head (indicator, set update)"),
    (lattice_newton, "_condensed_residual", "residual assembly (f64)"),
    (lattice_newton, "_fused_active_set_update_lat",
     "PDAS head (indicator, set update)"),
    (lattice, "_prepare64", "f64 element matrices (ndl jvps)"),
    (lattice, "_prepare32_from64", "f32 cast + Galerkin RAP chain"),
    (lattice, "_prepare_levels", "level build (diag, lambda, Cholesky)"),
    (lattice, "_pass_setup", "CG pass setup (f64 -> f32)"),
    (lattice, "_cg_pass32", "f32 CG + V-cycle"),
    (lattice, "_pass_apply_mat", "f64 refinement residual"),
]


def _params(dim, refine, shards):
    sharding = (dict(n_devices=shards, dof_sharding="lattice") if shards
                else {})
    return config.load_parameters(
        os.path.join(REPO, "params", f"parameters_sneddon_{dim}d.prm"),
        n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
        cg_maxiter=3000, dtype="float64", mixed_precision_cg=True,
        **sharding)


def _run(dim, refine, shards):
    t0 = time.perf_counter()
    sim = Simulation(_params(dim, refine, shards), device="cuda",
                     verbose=False)
    sim.host_setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    return sim, time.perf_counter() - t0


def _report(sim, wall, label):
    print(f"{label}: forest + mesh {sim.host_setup_s:.3f} s; run {wall:.3f}"
          f" s, of which setup system {sim.timer.wall['Setup system']:.3f}"
          " s; per step " + ", ".join(
        f"{s:.3f} s" for _, _, s in sim.step_times) + "; Newton/linear its "
        + str([(e[1], e[2]) for e in sim.solver_effort]))


def phase_timing(dim, refine, shards):
    acc = collections.defaultdict(lambda: [0.0, 0, 0])
    originals = []
    # the outermost phase on the stack owns the time
    depth = [0]

    def wrap(mod, name, label):
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        @functools.wraps(fn)
        def timed(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                acc[label][0] += time.perf_counter() - t0
                acc[label][1] += 1
                acc[label][2] = max(acc[label][2],
                                    torch.cuda.max_memory_allocated())
                depth[0] -= 1
        setattr(mod, name, timed)

    for mod, name, label in PHASES:
        wrap(mod, name, label)
    try:
        sim, wall = _run(dim, refine, shards)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    _report(sim, wall, "phase-timed run")
    total = sum(t for t, _, _ in acc.values())
    for label, (t, n, peak) in sorted(acc.items(),
                                      key=lambda kv: -kv[1][0]):
        print(f"  {label:42s} {t:8.3f} s {100 * t / wall:5.1f} %  "
              f"({n} calls, peak device memory {peak / 1e9:.2f} GB)")
    print(f"  {'(other: driver, line-search glue, host)':42s} "
          f"{wall - total:8.3f} s {100 * (wall - total) / wall:5.1f} %")


def _is_stencil_kernel(name):
    """A device kernel of the unsharded stencil libraries."""
    return (("lattice_stencil" in name or "phi_kernel" in name)
            and "sharded" not in name)


def _logged_launches():
    """Wrap the unsharded and the sharded stencil launches to log (dim,
    dtype, k_in, k_out, cell grid) per launch; returns (unsharded log,
    sharded log, undo)."""
    unsharded, sharded = [], []
    launch, matvec_sharded = stencil._launch, lattice.stencil_matvec_sharded

    def logged(load, dim, jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
        unsharded.append((dim, str(X.dtype).replace("torch.", ""), k_in,
                          k_out, tuple(jac.shape[2:])))
        return launch(load, dim, jac, X, lo_r, hi_r, lo_c, hi_c, k_in,
                      k_out)

    def logged_sharded(JP, X, k, mesh):
        sharded.append((X.dim() - 1, str(X.dtype).replace("torch.", ""), k,
                        k, tuple(g - 1 for g in X.shape[1:])))
        return matvec_sharded(JP, X, k, mesh)

    def undo():
        stencil._launch = launch
        lattice.stencil_matvec_sharded = matvec_sharded
    stencil._launch = logged
    lattice.stencil_matvec_sharded = logged_sharded
    return unsharded, sharded, undo


def _launches_by_level(unsharded, sharded, kern):
    """Print the launches per (product, level), finest level first, with
    the median device time of the unsharded ones (paired in order with
    the stencil kernels of the trace)."""
    events = sorted((e for e in kern if _is_stencil_kernel(e.name)),
                    key=lambda e: e.time_range.start)
    paired = len(events) == len(unsharded)
    if not paired:
        print(f"  ({len(events)} stencil kernels in the trace for "
              f"{len(unsharded)} logged launches: no device times)")
    times = collections.defaultdict(list)
    for i, key in enumerate(unsharded):
        times[key].append(events[i].time_range.elapsed_us() if paired
                          else float("nan"))
    print("stencil launches by product and level (both load steps; device "
          "us per launch, median):")
    for key in sorted(times, key=lambda k: (k[0], k[1], -k[2], -k[3],
                                            tuple(-c for c in k[4]))):
        d, dt, k_in, k_out, cells = key
        t = times[key]
        print(f"  {d}d {dt} k_in={k_in} k_out={k_out} "
              f"{'x'.join(map(str, cells))} cells: {len(t):5d} launches, "
              f"{statistics.median(t):8.1f} us")
    for key, n in sorted(collections.Counter(sharded).items()):
        d, dt, k, _, cells = key
        print(f"  {d}d {dt} k={k} {'x'.join(map(str, cells))} cells, "
              f"sharded product: {n:5d} launches")
    finest = [k for k in times if k[1] == "float32" and k[2] == k[3] == 1]
    if finest and paired:
        key = max(finest, key=lambda k: k[4])
        t = times[key]
        print(f"finest f32 phase-field product "
              f"({'x'.join(map(str, key[4]))} cells): median "
              f"{statistics.median(t):.1f} us per launch (min {min(t):.1f},"
              f" max {max(t):.1f}) over {len(t)} launches")


def profiled(dim, refine, shards, out_path):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kernel = stencil.stencil_matvec2d if dim == 2 else stencil.stencil_matvec3d
    kernel.launches = 0
    stencil.stencil_matvec_sharded.launches = 0
    unsharded, sharded, undo = _logged_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim, wall = _run(dim, refine, shards)
    finally:
        undo()
    _report(sim, wall, "profiled run")
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    dev_total = sum(t for t, _ in by_name.values())
    print(f"device busy {busy / 1e6:.3f} s of {wall:.3f} s wall: idle "
          f"share {100 * (1 - busy / 1e6 / wall):.1f} %; {len(kern)} "
          f"device events; unsharded stencil launches {kernel.launches}, "
          f"sharded-product launches "
          f"{stencil.stencil_matvec_sharded.launches} (one per fine-level "
          f"product)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, n) in top:
        print(f"  {t / 1e3:9.2f} ms {100 * t / dev_total:5.1f} % {n:7d}x  "
              f"{name[:90]}")
    print("stencil kernel variants (all levels, both load steps):")
    for name, (t, n) in sorted(by_name.items()):
        if _is_stencil_kernel(name) or "sharded_kernel" in name:
            print(f"  {t / 1e3:9.2f} ms {n:7d}x  {name[:100]}")
    _launches_by_level(unsharded, sharded, kern)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dim = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    refine = int(sys.argv[2]) if len(sys.argv) > 2 else {2: 6, 3: 3}[dim]
    shards = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"Sneddon {dim}d refine {refine}, "
          + (f"dof_sharding = lattice on {shards} shards" if shards
             else "replicated"))
    sim, wall = _run(dim, refine, shards)
    _report(sim, wall, "warm-up run")
    del sim
    sim, wall = _run(dim, refine, shards)
    _report(sim, wall, "plain run")
    del sim
    phase_timing(dim, refine, shards)
    suffix = f"_sharded{shards}" if shards else ""
    profiled(dim, refine, shards, os.path.join(
        REPO, "chiprun_out", f"profile_torch_sneddon{dim}d{suffix}.txt"))
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B")


if __name__ == "__main__":
    main()
