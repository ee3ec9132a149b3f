"""Phase 23 of chip_smoke.py alone (the replicated cell-axis mode on W
ranks of the card), with the references it is held to: phase 5's 2d
bench case (refine 6, replicated, two load steps) and phase 9's
sneddon_3d_1 run, then the one-process references of its small cases,
then one launch of W ranks per W that runs only phase 23's work.

    python3 scripts/replicated_ranked.py

Prints what chip_smoke.py prints for those phases and each launch's
seconds; the output also goes to chiprun_out/replicated_ranked.log.
About 2 minutes on one NVIDIA H100 (the kernels' build included).
"""

import contextlib
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def main():
    import chip_smoke as cs
    t0 = time.perf_counter()
    cs.device_phase()
    cs._timed(cs.build_phase)
    main2d = cs._timed(cs.main_phase, 2)
    golden3d = cs._timed(cs.golden3d_phase)
    refs = cs._timed(cs.replicated_refs_phase)
    work = cs.replicated_work()
    outs_by_w, samples = {}, []
    for W in sorted(work):
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outs = cs._launch_on_card(
                cs._ranked_lattice, W, ([], False, False, None, work[W]),
                tmp, samples if W == cs.REPLICATED_FULL_W else None)
        outs_by_w[W] = [o[5] for o in outs]
        print(f"launch of {W} ranks: {time.perf_counter() - t1:.1f} s",
              flush=True)
    cs._timed(cs.replicated_ranked_phase, refs, (outs_by_w, samples),
              main2d, golden3d)
    print(f"replicated_ranked: {time.perf_counter() - t0:.1f} s in all")


if __name__ == "__main__":
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "replicated_ranked.log"), "w") as log, \
            contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        main()
