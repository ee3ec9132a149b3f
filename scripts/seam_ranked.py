"""Phase 17's full-width run and phase 22 of chip_smoke.py (the seam
lattice: bench.py's miehe_shear case at refinement 8, 790,275 DoFs,
replicated and on D = 4 row slabs of the card; then the same on W
ranks of the card) for one or more checkouts of the repo, so that a
parent's phase-17 energies and this tree's are printed by one call.

    python3 scripts/seam_ranked.py ROOT [ROOT ...]

Each ROOT is a checkout (this one: `.`; a parent unpacked with `git
archive` into `_archive/`).  Each runs in a fresh process of its own,
in the order given, with its own kernel build: phase 17's full-width
run (chip_smoke.miehe_full_phase), then, where its chip_smoke.py has
it, phase 22 (seam_ranked_phase).  The output also goes to
chiprun_out/seam_ranked.log.  About 2 minutes for a parent, 5-10 for a
tree with phase 22, on one NVIDIA H100.
"""

import os
import subprocess
import sys

RUN = r"""
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
cs.device_phase()
cs.build_phase()
seam = cs._timed(cs.miehe_full_phase)
if hasattr(cs, "seam_ranked_phase"):
    cs._timed(cs.seam_ranked_phase, seam)
"""


def main(roots):
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    failed = []
    with open(os.path.join(out_dir, "seam_ranked.log"), "w") as log:
        for root in roots:
            root = os.path.abspath(root)
            print(f"== {root}", flush=True)
            log.write(f"== {root}\n")
            proc = subprocess.run([sys.executable, "-c", RUN.format(root=root)],
                                  cwd=root, capture_output=True, text=True)
            for text in (proc.stdout, proc.stderr[-8000:]):
                sys.stdout.write(text)
                log.write(text)
            sys.stdout.flush()
            log.flush()
            if proc.returncode:
                failed.append(root)
    if failed:
        sys.exit(f"failed: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["."])
