"""Phase 7 of chip_smoke.py (the Sneddon lattice main path on the card:
2d refine 6, 1,232,643 DoFs, and 3d refine 3, 2,125,764 DoFs, two load
steps each, lattice GMG mixed-precision CG), replicated and on D = 4
row slabs (dof_sharding = lattice), for one or more checkouts of the
repo, so that two versions of the port are compared in one call.

    python3 scripts/lattice_main_path.py ROOT[:CHUNK] [ROOT[:CHUNK] ...]

Each ROOT is a checkout (this one: `.`); CHUNK, where given, sets its
`solvers/lattice.py::CELL_CHUNK` (the cells per piece of the lattice's
contractions) for the run.  Each runs in a fresh process
of its own, in the order given (give parent, change, change, parent),
with its own kernel build, and prints its steps' seconds, Newton and
linear iterations and peak device memory (chip_smoke.main_phase's
lines), then one summary line per ROOT.
"""

import os
import re
import subprocess
import sys

RUN = r"""
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
if {chunk}:
    from cracks_tpu_torch.solvers import lattice
    lattice.CELL_CHUNK = {chunk}
cs.build_phase()
for dim in (2, 3):
    rep = cs.main_phase(dim)
    cs.main_phase(dim, replicated=rep, n_devices=4, dof_sharding="lattice")
"""


def main(roots):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    summary = []
    for arg in roots:
        root, _, chunk = arg.partition(":")
        root = os.path.abspath(root)
        print(f"=== {arg}", flush=True)
        run = subprocess.run([sys.executable, "-c",
                              RUN.format(root=root, chunk=int(chunk or 0))],
                             cwd=root, capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if "main path" in ln or ln.startswith("build")]
        print("\n".join(lines), flush=True)
        if run.returncode:
            print(run.stderr[-4000:], flush=True)
            raise SystemExit(f"{arg}: exit {run.returncode}")
        steps = re.findall(r"^(\S+(?: sharded \(D=4[^)]*\))?) main path "
                           r"step \d+: ([\d.]+) s", run.stdout, re.M)
        peaks = re.findall(r"^(\S+(?: sharded \(D=4[^)]*\))?) main path: "
                           r"\d+ DoFs.*?peak device memory (\d+) B",
                           run.stdout, re.M)
        per = {}
        for label, secs in steps:
            per.setdefault(label, []).append(float(secs))
        summary.append(f"{arg}: " + "; ".join(
            f"{label} s/step {per.get(label)} peak {int(b) / 1e9:.2f} GB"
            for label, b in peaks))
    print("\n".join(summary))


if __name__ == "__main__":
    main(sys.argv[1:] or ["."])
