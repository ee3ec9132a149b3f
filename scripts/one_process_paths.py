"""The one-process card paths of chip_smoke.py that the replicated
cell-axis mode's pieces and the per-row dots of the replicated lattice
solve run through: phase 5 (the Sneddon lattice main path, 2d refine 6
and 3d refine 3, replicated, two load steps each), phase 11 (the
shipped Sneddon file four times finer on the stored-matrix Jacobi CG,
four mesh epochs) and phase 15 (the heterogeneous 3d production mesh
under the Galerkin GMG's split solve, load step 0), for one or more
checkouts of the repo, so that two versions of the port are compared
in one call.

    python3 scripts/one_process_paths.py [--phases=5-2d,5-3d,11,15] ROOT
        [ROOT ...]

Each ROOT is a checkout (this one: `.`); `--phases` runs only the
phases named (by default all four).  Each runs in a fresh process
of its own, in the order given (give parent, change, change, parent),
with its own kernel build, and prints per phase its seconds, its steps'
seconds where the phase prints them and its peak device memory
(`torch.cuda.max_memory_allocated` from a reset at the phase's start),
then one summary line per ROOT.  The output also goes to
chiprun_out/one_process_paths.log.
"""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
cs.build_phase()
out = {{}}
for name, fn in (("phase 5-2d", lambda: cs.main_phase(2)),
                 ("phase 5-3d", lambda: cs.main_phase(3)),
                 ("phase 11", cs.production_phase),
                 ("phase 15", cs.hetero3d_phase)):
    if name[6:] not in {phases!r}:
        continue
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out[name] = dict(secs=time.perf_counter() - t0,
                     peak=torch.cuda.max_memory_allocated())
print("RESULT " + json.dumps(out), flush=True)
"""


def main(args):
    phases = ["5-2d", "5-3d", "11", "15"]
    if args and args[0].startswith("--phases="):
        phases = args[0][len("--phases="):].split(",")
        args = args[1:]
    roots = args or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    summary = []
    for arg in roots:
        root = os.path.abspath(arg)
        print(f"=== {arg}", flush=True)
        run = subprocess.run([sys.executable, "-c",
                              RUN.format(root=root, phases=phases)],
                             cwd=root, capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if "main path" in ln or ln.startswith(("build", "hetero",
                                                        "production"))]
        print("\n".join(ln[:600] for ln in lines), flush=True)
        if run.returncode:
            print(run.stderr[-4000:], flush=True)
            raise SystemExit(f"{arg}: exit {run.returncode}")
        res = json.loads(next(ln for ln in run.stdout.splitlines()
                              if ln.startswith("RESULT "))[7:])
        for name, pattern in (
                ("phase 5-2d", r"^2d main path step \d+: ([\d.]+) s"),
                ("phase 5-3d", r"^3d main path step \d+: ([\d.]+) s"),
                ("phase 11", r"^production epoch 4: .*?mean without the "
                             r"run's first step ([\d.]+)\)"),
                ("phase 15", r"^hetero-3d step \d+: \d+ DoFs, ([\d.]+) s")):
            if name in res:
                res[name]["step_s"] = [float(t) for t in re.findall(
                    pattern, run.stdout, re.M)]
        summary.append((arg, res))
    print("summary (seconds per phase; s per step, for phase 11 the last "
          "epoch's mean without its first step; peak device memory B):")
    for arg, res in summary:
        print(f"{arg}: " + "; ".join(
            f"{k} {v['secs']:.3f} s"
            + (f", steps {v['step_s']} s" if v.get("step_s") else "")
            + f", peak {v['peak']}" for k, v in res.items()), flush=True)


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


if __name__ == "__main__":
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "one_process_paths.log"),
              "w") as log:
        sys.stdout = _Tee(sys.__stdout__, log)
        try:
            main(sys.argv[1:])
        finally:
            sys.stdout = sys.__stdout__
