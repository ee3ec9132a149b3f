"""Whether the per-cell terms of the flat element kernels keep their bits
when a process computes a range of the cells: the ground of the
replicated cell-axis mode on W ranks (`parallel/sharding.py::
CellRange`), whose ranks must hold the one-process run's bits.

    python3 scripts/cell_range_bits.py [cuda|cpu]

On seeded states of the meshes of sneddon_2d_1 (124 cells, one local
pre-refinement, hanging nodes), hetero_3d_1 (932 cells), hetero_3d_1
at global refine 5 (38,375 cells after its local pre-refinements: a
cell count that neither 2 nor 4 divides, between the card's smallest
piece and 10^5 cells), the Sneddon 2d lattice at refine 6 (409,600
cells) and the Sneddon 3d lattice at refine 3 (512,000 cells; on the
CPU the last three at global refine 4, refine 4 and refine 1), the
cells split as n_devices = D splits them (D = 2 and 4, every shard,
and W = 2 ranks of D = 4): for each range, the terms that
`ops/physics.py` and `solvers/assembled.py` hand to the ordered
scatter (the residual, the jvp, the exact and the analytic Jacobi
diagonals, the stored element matrices' u, phi and pu products and
diagonals) and the element matrices themselves, each computed in the
card's pieces of a mesh on D > 1 shards (`ops/scatter.py::in_pieces`,
each cell at its place in the mesh's pieces; on the CPU at once), are
compared bit for bit with the same cells of the whole mesh's in pieces
(the one-process run at n_devices = D) and at once (n_devices = 1).
It also times all of them on the whole mesh (in pieces and at once)
and on the slowest range (synchronized wall clock, the first mesh's
whole run with the card's start-up).  The output also goes to
chiprun_out/cell_range_bits.log.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Caught(Exception):
    pass


def _terms(fn, piece, cells):
    from cracks_tpu_torch.ops.scatter import CellScatter

    class Tap(CellScatter):
        """A CellScatter of no tables, with the card's pieces of `piece`
        cells and the range `cells`, that keeps the per-cell terms of
        its cells handed to the gather before the scatter and stops the
        function there."""

        def all_cells(self, *values, axis=-1):
            self.values = values
            raise _Caught

    tap = Tap(None, None, 0, 0, cells, piece)
    try:
        fn(tap)
    except _Caught:
        return tap.values
    raise RuntimeError("the function reached no scatter")


def _timed(dev, fn):
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _system(dev, prm, over):
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation, SolutionState
    sim = Simulation(config.load_parameters(
        os.path.join(ROOT, "params", prm), output_dir="", **over),
        device=dev, verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    f64 = dict(dtype=torch.float64, device=sim.device)
    zu = torch.zeros(sim.mesh.n_vertices * sim.mesh.dim, **f64)
    zp = torch.zeros(sim.mesh.n_vertices, **f64)
    state = SolutionState(u=zu, phi=zp, u_old=zu, phi_old=zp, phi_oold=zp)
    for _ in range(sim.p.n_local_pre_refine):
        sim.interpolate_initial_values(state)
        state.u_old, state.phi_old, state.phi_oold = (state.u, state.phi,
                                                      state.phi)
        sim.refine_mesh(state)
    sim._set_context()
    return sim.sys


def _all_terms(sys_, ca, inputs, piece, cells=None):
    """name -> the per-cell terms of ca's cells (`cells`, a CellRange,
    or all; cell axis last), in the pieces of `piece` cells on the card
    (0: at once)."""
    from cracks_tpu_torch.ops import physics
    from cracks_tpu_torch.ops.scatter import CellScatter
    from cracks_tpu_torch.solvers import assembled
    u, phi, pfo, pfoo, du, dp, xu, xp = inputs
    sc, dim = sys_.scalars, sys_.dim
    kw = dict(dim=dim, with_split=dim == 2, monolithic=False)
    jac = physics.element_matrices(u, phi, pfo, pfoo, ca, sc, **kw,
                                   cs=CellScatter(None, None, 0, 0, cells,
                                                  piece))
    t = lambda fn: _terms(fn, piece, cells)
    return dict(
        residual=t(lambda cs: physics.assemble_residual(
            u, phi, pfo, pfoo, ca, sc, cs, **kw)),
        jvp=t(lambda cs: physics.jacobian_vector_product(
            u, phi, du, dp, pfo, pfoo, ca, sc, cs, **kw)),
        jacobi=t(lambda cs: physics.jacobi_diagonal_approx(
            u, phi, pfo, pfoo, ca, sc, cs, dim=dim, monolithic=False)),
        matrices=(jac,),
        uu=t(lambda cs: assembled.matvec_uu(jac, ca, xu, cs, dim=dim)),
        pp=t(lambda cs: assembled.matvec_pp(jac, ca, xp, cs, dim=dim)),
        pu=t(lambda cs: assembled.matvec_pu(jac, ca, xu, cs, dim=dim)),
        diagonals=t(lambda cs: assembled.diagonals(jac, ca, cs, dim=dim)))


def main(dev):
    from cracks_tpu_torch.ops import scatter
    from cracks_tpu_torch.parallel import dist, sharding
    big2, big3, mid = (6, 3, 5) if dev == "cuda" else (4, 1, 4)
    meshes = [
        ("sneddon_2d_1", "tests/sneddon_2d_1.prm", dict()),
        ("hetero_3d_1", "tests/hetero_3d_1.prm",
         dict(preconditioner="jacobi")),
        (f"hetero_3d_1 global refine {mid}", "tests/hetero_3d_1.prm",
         dict(n_global_pre_refine=mid, n_local_pre_refine=3,
              preconditioner="jacobi")),
        (f"sneddon 2d refine {big2}", "parameters_sneddon_2d.prm",
         dict(n_global_pre_refine=big2, n_local_pre_refine=0,
              n_refinement_cycles=0, preconditioner="jacobi")),
        (f"sneddon 3d refine {big3}", "parameters_sneddon_3d.prm",
         dict(n_global_pre_refine=big3, n_local_pre_refine=0,
              n_refinement_cycles=0, preconditioner="jacobi"))]
    for name, prm, over in meshes:
        sys_ = _system(dev, prm, dict(linear_solver="cg", **over))
        n_v, dim, n_c = sys_.mesh.n_vertices, sys_.dim, sys_.mesh.n_cells
        gen = np.random.default_rng(7)
        draw = lambda n, lo, hi: torch.as_tensor(gen.uniform(lo, hi, n),
                                                 device=sys_.device)
        inputs = (draw(n_v * dim, -1e-2, 1e-2), draw(n_v, 0.0, 1.0),
                  draw(n_v, 0.0, 1.0), draw(n_v, 0.0, 1.0),
                  draw(n_v * dim, -1e-2, 1e-2), draw(n_v, -1.0, 1.0),
                  draw(n_v * dim, -1.0, 1.0), draw(n_v, -1.0, 1.0))
        piece = scatter.piece_size(n_c, 2)
        _all_terms(sys_, sys_.ca, inputs, piece)
        whole, t_whole = _timed(dev, lambda: _all_terms(sys_, sys_.ca,
                                                        inputs, piece))
        at_once, t_flat = _timed(dev, lambda: _all_terms(sys_, sys_.ca,
                                                         inputs, 0))
        same = ", ".join(
            f"{k} {all(torch.equal(a, b) for a, b in zip(v, at_once[k]))}"
            for k, v in whole.items())
        print(f"{name} on {dev}: {n_c} cells in pieces of "
              f"{piece} (`scatter.in_pieces`): all functions on all "
              f"cells {t_whole:.3f} s in pieces, {t_flat:.3f} s at once; "
              f"pieces bit-equal to at once: {same}", flush=True)
        card = (sys_.device if sys_.device.type == "cpu" else
                torch.device("cuda", torch.cuda.current_device()))
        for D, W in ((2, 2), (4, 4), (4, 2)):
            same = {k: True for k in whole}
            flat = {k: True for k in whole}
            straddle = 0
            t_one = None
            for r in range(W):
                ranks = dist.Ranks(r, W, card, "gloo")
                cells = sharding.CellRange(n_c, sharding.make_shard_mesh(
                    [card] * D, ranks=ranks))
                ca = cells.own(sys_.ca)
                part, t = _timed(dev, lambda: _all_terms(sys_, ca, inputs,
                                                         piece, cells))
                t_one = t if t_one is None else max(t_one, t)
                lo, hi = cells.lo, min(cells.hi, n_c)
                straddle += lo // piece != (hi - 1) // piece
                for k, vals in part.items():
                    for a, b, c in zip(vals, whole[k], at_once[k]):
                        same[k] &= torch.equal(a[..., :hi - lo],
                                               b[..., lo:hi])
                        flat[k] &= torch.equal(a[..., :hi - lo],
                                               c[..., lo:hi])
            print(f"  D = {D} on W = {W} ({straddle} of {W} ranges across "
                  "a piece boundary): every range bit-equal to the whole "
                  "mesh's in pieces: " + ", ".join(f"{k} {v}"
                                                   for k, v in same.items())
                  + "; to the whole mesh's at once: "
                  + ", ".join(f"{k} {v}" for k, v in flat.items())
                  + f"; slowest range {t_one:.3f} s", flush=True)
        del sys_, whole, part, at_once
        if dev == "cuda":
            torch.cuda.empty_cache()


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
    with open(os.path.join(ROOT, "chiprun_out", "cell_range_bits.log"),
              "w") as log:
        sys.stdout = _Tee(sys.__stdout__, log)
        try:
            main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
        finally:
            sys.stdout = sys.__stdout__
