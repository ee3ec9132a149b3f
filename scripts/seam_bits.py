"""Where the seam lattice's runs on W ranks part from the one-process
run: bench.py's miehe_shear case (refinement 8, 790,275 DoFs), load
step 0, at D = 4 row slabs, run in one process (at the default torch
thread count and at 2 threads) and on W = 4 ranks of the card, each
recording per CG pass its iterations and best residual, per Newton
solve the norms of its inputs and its update, per build of the f64
element matrices their sum of squares (all of them sums of per-row
sums, the same bits on any W), then the energies.

    python3 scripts/seam_bits.py [refine [device]]

Prints the first pass and the first solve at which the runs differ
(none if they agree) and each run's energies to the last bit.  About
3 minutes on one NVIDIA H100.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(ranks, refine, threads, device="cuda"):
    """One run of the case on this process's rows: (passes, solves,
    energies)."""
    import chip_smoke as cs
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers import lattice
    if threads:
        torch.set_num_threads(threads)
    passes, solves = [], []
    real_pass, real_solve = lattice._cg_pass32, lattice.solve_lattice_lat

    def pass32(*args, **kw):
        out = real_pass(*args, **kw)
        passes.append((kw["which"], out[1], out[2]))
        return out

    def solve(sys_, *args, **kw):
        sl = sys_.lattice_hierarchy.slabs[-1]
        n = sl.n
        # the state, the active set and the right-hand sides on entry
        ins = [x[:, :n].to(torch.float64) for x in args[:7]]
        norms_in = sl.dots(*((x, x) for x in ins))
        out = real_solve(sys_, *args, **kw)
        norms = sl.dots((out[0][:, :n], out[0][:, :n]),
                        (out[1][:, :n], out[1][:, :n]))
        solves.append([float(x) for x in norms_in.cpu()]
                      + [float(x) for x in norms.cpu()])
        return out

    def prepare64(*args, **kw):
        jac = real_prep(*args, **kw)
        sl = kw["sl"]
        if sl is not None:
            # the squares of the cells whose lower vertex row it owns, by
            # cell row, summed over the level's cell rows (any W)
            own = lattice._owned_cells(jac, sl)
            rows = (own * own).sum(dim=(0, 1, 3))
            full = rows.new_zeros(sl.g)
            full[sl.a:sl.a + rows.shape[0]] = rows
            if sl.ranked:
                full = lattice.gather_rows(full[None, sl.a:sl.a + rows.shape[0]],
                                           sl.mesh, [(a, min(b, sl.g - 1))
                                                     for a, b in sl.spans])[0]
            jacs.append(float(full.sum()))
        return jac

    real_prep = lattice._prepare64
    jacs = []
    lattice._cg_pass32, lattice.solve_lattice_lat = pass32, solve
    lattice._prepare64 = prepare64
    try:
        sim = Simulation(cs._miehe_params(refine, 1, n_devices=4,
                                          dof_sharding="lattice"),
                         device=device, verbose=False)
        sim.run()
    finally:
        lattice._cg_pass32, lattice.solve_lattice_lat = real_pass, real_solve
        lattice._prepare64 = real_prep
    stats = [sim.statistics.data[c][0] for c in cs.MIEHE_COLUMNS]
    return passes, solves, stats, jacs


def one_process(refine, threads, device):
    """The one-process run in a fresh interpreter (its own CUDA state)."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r}); "
            "import pickle, seam_bits; "
            f"sys.stdout.buffer.write(pickle.dumps(seam_bits.run(None, "
            f"{refine}, {threads}, {device!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         check=True)
    import pickle
    return pickle.loads(out.stdout)


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return None if len(a) == len(b) else (min(len(a), len(b)), None, None)


def main():
    from cracks_tpu_torch.parallel import dist
    refine = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    if device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip())
    runs = {"one process, default threads": one_process(refine, 0, device),
            "one process, 2 threads": one_process(refine, 2, device)}
    with tempfile.TemporaryDirectory() as tmp:
        ranked = dist.launch(run, 4, args=(refine, 0, device), device=device,
                             rendezvous_dir=tmp, deadline_s=900,
                             n_threads=2)
    for r, out in enumerate(ranked):
        runs[f"rank {r} of 4"] = out
    ref_name, ref = next(iter(runs.items()))
    for name, (passes, solves, stats, jacs) in runs.items():
        print(f"{name}: {len(passes)} CG passes, {len(solves)} solves, "
              f"energies {[repr(float(x)) for x in stats]}")
        if name == ref_name:
            continue
        print(f"  against {ref_name}: first pass differing "
              f"{first_difference(passes, ref[0])}, first solve differing "
              f"(U, P, P_old, P_oold, active, rhs u, rhs p; DU, DP: "
              f"squared norms) {first_difference(solves, ref[1])}, first "
              f"f64 element-matrix build differing "
              f"{first_difference(jacs, ref[3])}, energies equal "
              f"{np.array_equal(stats, ref[2])}")


if __name__ == "__main__":
    main()
