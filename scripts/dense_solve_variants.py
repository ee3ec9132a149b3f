"""How the dense direct solve's rounding moves the Miehe and three-point
results: the port's goldens and the shipped Miehe shear file with the
solve of `solvers/linear.py` taken several ways.

    python3 scripts/dense_solve_variants.py [--quick]  # on the card
    python3 scripts/dense_solve_variants.py --cpu      # on the CPU

On the card, for each variant (cuSOLVER's factor or the host's LAPACK
factor on 8 threads or on 1, with 0, 1 or 2 steps of iterative
refinement), the four goldens in full under `chip_smoke.py`'s tolerances
(cells off and the largest relative deviation) and the shipped Miehe
file's first 100 steps against the JAX table
(tests/torch_reference/parameters_miehe_shear_adaptive.statistics, rel
1e-7), and the seconds of one factor + solve at 3,315 and 5,142 DoFs;
then, per golden and for the shipped file, the rows on which every
variant's table agrees to rel 1e-8 (where the card's result does not
depend on the solve's rounding) and each row's largest spread.  With
--quick only the first four variants run (cuSOLVER with 0, 1 and 2
refinement steps, host LAPACK on 8 threads).  On the CPU (LAPACK), for 1 and 8 threads and 0 and 2 refinement steps,
the tension golden's last softening row against the golden and the
three-point golden's first 4 rows against the unrefined run (which the
CPU tests hold to the JAX package's).  Each variant wraps
`linear._lu_solve` for its runs; about 25 minutes on the card (the
1-thread host factor is slow; --quick about 5), 3 on the CPU.
"""

import contextlib
import io
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cracks_tpu_torch import config  # noqa: E402
from cracks_tpu_torch.driver import Simulation  # noqa: E402
from cracks_tpu_torch.solvers import linear  # noqa: E402


@contextlib.contextmanager
def lu_variant(where, threads, refinements):
    """For the runs inside: `linear._lu_solve` with the factor on
    `where` ("device" or "host"), on `threads` host threads (0: as
    set), refined `refinements` times."""
    shipped = linear._lu_solve

    def solve(A_red, b, _):
        dev = A_red.device
        if where == "host":
            A_red, b = A_red.cpu(), b.cpu()
        before = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        try:
            x, lu = shipped(A_red, b, refinements)
        finally:
            torch.set_num_threads(before)
        return x.to(dev), lu

    linear._lu_solve = solve
    try:
        yield
    finally:
        linear._lu_solve = shipped


def run(prm, device, **overrides):
    with contextlib.redirect_stdout(io.StringIO()):
        sim = Simulation(config.load_parameters(prm, output_dir="",
                                                **overrides),
                         device=device, verbose=False)
        sim.run()
    return chip_smoke.parse_statistics(sim.statistics.write_text())


def golden(name):
    table = next(g[1] for g in chip_smoke.GOLDENS if g[0] == name)
    with open(os.path.join(chip_smoke.GOLDEN_DIR, table)) as f:
        return chip_smoke.parse_statistics(f.read())


def golden_tables(device):
    """Per golden: (cells off, largest relative deviation, the table)."""
    out = {}
    for name, _, overrides, softening_from, softening in chip_smoke.GOLDENS:
        names, ours = run(os.path.join(chip_smoke.PRM_TESTS, f"{name}.prm"),
                          device)
        g_names, g = golden(name)
        fails = chip_smoke.golden_failures(names, ours, g_names, g,
                                           overrides, softening_from,
                                           softening)
        rel = np.nanmax(np.abs(ours - g) / np.maximum(np.abs(g), 1e-300))
        out[name] = (len(fails), float(rel), ours)
    return out


def row_spread(tables):
    """Per row, the largest relative spread of any cell over the
    variants' tables: (max - min) / max |value|."""
    t = np.stack(tables)
    with np.errstate(invalid="ignore", divide="ignore"):
        spread = ((np.nanmax(t, axis=0) - np.nanmin(t, axis=0))
                  / np.maximum(np.nanmax(np.abs(t), axis=0), 1e-300))
    return np.nan_to_num(spread).max(axis=1)


def stable_ranges(spread, tol=1e-8):
    """The row ranges whose spread is at most `tol`, as "a-b" strings."""
    out, start = [], None
    for i, ok in enumerate(list(spread <= tol) + [False]):
        if ok and start is None:
            start = i
        elif not ok and start is not None:
            out.append(f"{start}-{i - 1}" if i - 1 > start else f"{start}")
            start = None
    return out


def factor_seconds(where, threads, refinements, n):
    dev = "cuda" if where == "device" else "cpu"
    A = (torch.randn(n, n, dtype=torch.float64)
         + n * torch.eye(n, dtype=torch.float64)).to(dev)
    b = torch.randn(n, 1, dtype=torch.float64, device=dev)
    before = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            linear._lu_solve(A, b, refinements)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        torch.set_num_threads(before)
    return min(times[1:])


CARD_VARIANTS = [("device", 0, 0), ("device", 0, 1), ("device", 0, 2),
                 ("host", 8, 0), ("host", 8, 1), ("host", 1, 0),
                 ("host", 1, 1)]


def card(quick):
    """Every variant (with --quick the first four) on the card, then per
    golden and for the shipped Miehe file the rows on which all of them
    agree to rel 1e-8."""
    chip_smoke.device_phase()
    with open(os.path.join(chip_smoke.REFERENCE_DIR,
                           "parameters_miehe_shear_adaptive.statistics")) as f:
        _, ref = chip_smoke.parse_statistics(f.read())
    tables = {}
    for where, threads, refinements in CARD_VARIANTS[:4 if quick else None]:
        factor = ("cuSOLVER" if where == "device"
                  else f"host LAPACK, {threads} threads")
        label = f"{factor} + {refinements} refinement steps"
        with lu_variant(where, threads, refinements):
            t0 = time.perf_counter()
            cells = golden_tables("cuda")
            _, ours = run(chip_smoke.SHIPPED_MIEHE_PRM, "cuda",
                          max_no_timesteps=len(ref) - 1)
        fails = chip_smoke.table_failures(ours, ref, 0.0, 1e-7)
        rel = float(np.nanmax(np.abs(ours - ref) / np.abs(ref)))
        for name, (_, _, table) in cells.items():
            tables.setdefault(name, []).append(table)
        tables.setdefault("shipped Miehe, 100 rows", []).append(ours)
        secs = [factor_seconds(where, threads, refinements, n)
                for n in (3315, 5142)]
        print(f"{label}: goldens (cells off, max rel) "
              f"{ {k: v[:2] for k, v in cells.items()} }; shipped Miehe "
              f"100 rows: {len(fails)} cells off, max rel {rel:.3e}; factor "
              f"+ solve {secs[0]:.4f} s at 3,315 and {secs[1]:.4f} s at "
              f"5,142 DoFs; {time.perf_counter() - t0:.1f} s", flush=True)
    for name, ts in tables.items():
        if len({t.shape for t in ts}) > 1:
            print(f"{name}: the variants' tables differ in length "
                  f"{[len(t) for t in ts]}")
            continue
        spread = row_spread(ts)
        print(f"{name}: rows equal to rel 1e-8 across the {len(ts)} "
              f"variants {stable_ranges(spread)} of {len(spread)}; largest "
              f"spread per row {[float(f'{x:.1e}') for x in spread]}",
              flush=True)


def cpu():
    tp = os.path.join(chip_smoke.PRM_TESTS, "threepoint_1.prm")
    _, plain = run(tp, "cpu", max_no_timesteps=3)
    g_names, g = golden("miehe_tension_adaptive_1")
    col = g_names.index("Bulk Energy")
    for threads in (1, 8):
        for refinements in (0, 2):
            with lu_variant("host", threads, refinements):
                _, ours = run(os.path.join(chip_smoke.PRM_TESTS,
                                           "miehe_tension_adaptive_1.prm"),
                              "cpu")
                _, tp4 = run(tp, "cpu", max_no_timesteps=3)
            dev = abs(ours[-1, col] - g[-1, col]) / g[-1, col]
            tp_rel = float(np.nanmax(np.abs(tp4 - plain) / np.abs(plain)))
            print(f"CPU LAPACK, {threads} threads + {refinements} refinement "
                  f"steps: tension last row bulk energy {dev:.3e} off the "
                  f"golden; threepoint 4 rows max rel {tp_rel:.3e} off the "
                  f"unrefined run", flush=True)


if __name__ == "__main__":
    if "--cpu" in sys.argv[1:]:
        cpu()
    else:
        card("--quick" in sys.argv[1:])
