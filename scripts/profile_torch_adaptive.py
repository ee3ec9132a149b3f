"""Where the time goes in the PyTorch port's adaptive Sneddon 2d run
(hanging-node meshes, the dense direct solve and the stored-element-
matrix Jacobi CG) on one CUDA card.

    python3 scripts/profile_torch_adaptive.py [n_global_pre_refine]
    python3 scripts/profile_torch_adaptive.py [n_global_pre_refine] \
        --tangents-per-pass

Runs ``params/parameters_sneddon_2d.prm`` with the given global
pre-refinement (default 2: the production run of chip_smoke.py, last
epoch 168,609 DoFs) and ``cg_maxiter=20000`` twice on the card:

1. phase timing: the solver's phases are wrapped with a synchronize on
   both sides and a host clock (the outermost wrapped phase owns the
   time; the synchronizes add a little of their own), per mesh epoch;
2. torch.profiler over one load step of the last
   epoch (its second): device time by kernel name, and the union of
   device-busy intervals against the step's wall time (the device's
   idle share).

Prints the card's name and power limit first; writes the profiler's
table to chiprun_out/profile_torch_adaptive.txt.

With --tangents-per-pass: the element build's cost by how many one-hot
tangents a vmapped pass takes (ops/physics.JVP_BATCH_CELL_TANGENTS).
The phase-timed run, without an output directory (chip_smoke.py's
production run), four times in turns: the default (all ndl tangents
per pass below 2^18 cells), one tangent per pass, one, the default;
each with its phases and its peak device memory per epoch.
"""

import collections
import functools
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cracks_tpu_torch import config, driver  # noqa: E402
from cracks_tpu_torch.ops import physics  # noqa: E402
from cracks_tpu_torch.solvers import assembled, linear, newton  # noqa: E402

PHASES = [
    (assembled, "build_jacobians", "f64/f32 element matrices (jvps)"),
    (assembled, "diagonals", "Jacobi diagonals"),
    (assembled, "solve_cg_block", "Jacobi CG (stored matrices)"),
    (assembled, "residual_update", "f64 refinement residual"),
    (linear, "solve_direct", "dense direct solve"),
    (newton, "_assemble", "residual assembly (f64)"),
    (newton, "_active_set_update", "PDAS head (indicator, set update)"),
    (driver.Simulation, "refine_mesh", "refinement + system setup"),
    (driver.Simulation, "_write_cod_array", "COD profile (host numpy)"),
    (driver.Simulation, "_write_cod_profile", "COD sweep (host numpy)"),
]


def _params(refine):
    return config.load_parameters(
        os.path.join(REPO, "params", "parameters_sneddon_2d.prm"),
        n_global_pre_refine=refine, cg_maxiter=20000, output_dir=os.path.join(
            REPO, "chiprun_out", "profile_torch_adaptive_out"))


def _report(sim, wall, label):
    data = sim.statistics.data
    print(f"{label}: {wall:.3f} s, {sim.step_cuts} time-step cuts; bulk "
          f"energy {data['Bulk Energy']!r}; crack energy "
          f"{data['Crack Energy']!r}; TCV "
          f"{[v for v in data['TCV'] if v != '']!r}")
    by_epoch = collections.OrderedDict()
    for (step, newton_its, lin, _), (_, dofs, secs) in zip(
            sim.solver_effort, sim.step_times):
        by_epoch.setdefault(dofs, []).append((step, secs, newton_its, lin))
    for dofs, steps in by_epoch.items():
        print(f"  {dofs:7d} DoFs: s/step "
              f"{[round(s, 3) for _, s, _, _ in steps]}, Newton/linear its "
              f"{[(n, l) for _, _, n, l in steps]}")


def phase_timing(refine, output=True):
    acc = collections.defaultdict(lambda: collections.defaultdict(float))
    peaks = []
    originals = []
    depth = [0]
    epoch = [0]

    def wrap(owner, name, label):
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        @functools.wraps(fn)
        def timed(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                acc[label][epoch[0]] += time.perf_counter() - t0
                depth[0] -= 1
        setattr(owner, name, timed)

    for owner, name, label in PHASES:
        wrap(owner, name, label)
    p = _params(refine)
    sim = driver.Simulation(p if output else p.replace(output_dir=""),
                            device="cuda", verbose=False)
    epoch_dofs = []

    def current_epoch(sys_, state, time_, verbose=True):
        if not epoch_dofs or epoch_dofs[-1] != sys_.mesh.n_dofs:
            if epoch_dofs:
                peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            epoch_dofs.append(sys_.mesh.n_dofs)
        epoch[0] = len(epoch_dofs) - 1
        return solve(sys_, state, time_, verbose=verbose)

    solve = newton.newton_active_set
    newton.newton_active_set = current_epoch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        newton.newton_active_set = solve
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    peaks.append(torch.cuda.max_memory_allocated())
    _report(sim, wall, "phase-timed run")
    walls = collections.defaultdict(float)
    for _, dofs, secs in sim.step_times:
        walls[epoch_dofs.index(dofs)] += secs
    for k, dofs in enumerate(epoch_dofs):
        print(f"  epoch {k + 1} ({dofs} DoFs), load steps {walls[k]:.3f} s, "
              f"peak device memory {peaks[k]} B (the epoch's Newton "
              "solves):")
        for label in sorted(acc, key=lambda lb: -acc[lb][k]):
            if acc[label][k] > 0:
                print(f"    {label:40s} {acc[label][k]:8.3f} s")
    total = sum(sum(v.values()) for v in acc.values())
    print(f"  all phases {total:.3f} s of {wall:.3f} s (the rest: driver, "
          "line-search glue, statistics)")
    return epoch_dofs[-1]


def profiled_step(refine, last_dofs, out_path):
    """torch.profiler over the second load step of the last epoch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    solve = newton.newton_active_set
    seen = [0]
    result = {}

    def maybe_profiled(sys_, state, time_, verbose=True):
        if sys_.mesh.n_dofs != last_dofs:
            return solve(sys_, state, time_, verbose=verbose)
        seen[0] += 1
        if seen[0] != 2:
            return solve(sys_, state, time_, verbose=verbose)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve(sys_, state, time_, verbose=verbose)
            torch.cuda.synchronize()
            result["wall"] = time.perf_counter() - t0
        result["prof"] = prof
        result["its"] = (state.last_log.newton_steps,
                         state.last_log.linear_iterations)
        return out

    newton.newton_active_set = maybe_profiled
    try:
        sim = driver.Simulation(_params(refine), device="cuda", verbose=False)
        sim.run()
    finally:
        newton.newton_active_set = solve
    prof, wall = result["prof"], result["wall"]
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
    print(f"profiled load step ({last_dofs} DoFs, Newton/linear its "
          f"{result['its']}): {wall:.3f} s wall, device busy "
          f"{busy / 1e6:.3f} s, idle share "
          f"{100 * (1 - busy / 1e6 / wall):.1f} %, {len(kern)} device "
          f"events ({len(kern) / max(result['its'][1], 1):.1f} per linear "
          "iteration)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / 1e3:9.2f} ms {100 * t / dev_total:5.1f} % {n:8d}x  "
              f"{name[:90]}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    refine = int(args[0]) if args else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"Sneddon 2d shipped file, n_global_pre_refine={refine}, "
          "cg_maxiter=20000")
    if "--tangents-per-pass" in sys.argv[1:]:
        default = physics.JVP_BATCH_CELL_TANGENTS
        for label, per_pass in (("all", None), ("one", 1), ("one", 1),
                                ("all", None)):
            physics.JVP_BATCH_CELL_TANGENTS = (default if per_pass is None
                                               else 1)
            print(f"element build with {label} tangents per pass "
                  f"(JVP_BATCH_CELL_TANGENTS = "
                  f"{physics.JVP_BATCH_CELL_TANGENTS}), no output "
                  "directory:")
            phase_timing(refine, output=False)
        physics.JVP_BATCH_CELL_TANGENTS = default
        return
    torch.cuda.reset_peak_memory_stats()
    last_dofs = phase_timing(refine)
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B")
    profiled_step(refine, last_dofs, os.path.join(
        REPO, "chiprun_out", "profile_torch_adaptive.txt"))


if __name__ == "__main__":
    main()
