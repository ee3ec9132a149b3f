"""Which lattice computations change their bits with the number of cell
rows they see: the ground of the lattice layout's slab code
(`parallel/sharding.py::Slab`), whose runs on W ranks must give the bits
of the one-process run.

    python3 scripts/slab_bits.py [cuda|cpu]

For the Sneddon lattice at 2d refine 3 and 6 and 3d refine 1, on a
seeded state, each computation on three row slabs (a process's halo'd
rows) is compared bit for bit with the same rows of the whole lattice's:
the f64 element matrices (the vmapped jvp of the element residual) and
the residual, each with its contractions over all the cells a caller
holds in one batched call ("batched") and in the lattice's pieces of a
fixed number of cell rows (`solvers/lattice.py::CELL_CHUNK`,
`RESIDUAL_CHUNK`, the port's), the f32 Galerkin coarsening (the same
two ways), the Gershgorin row sums as `sum(dim=1)` and as adds in
order, the per-row sums of the dot products (`Slab.dots`), and the f32
u and phase-field stencil products.  It also times the element matrices
and the residual both ways on the whole lattice (synchronized wall
clock; on the card with their peak memory).
"""

import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _batched():
    """Every contraction over all the cells of its call at once."""
    from cracks_tpu_torch.solvers import lattice
    chunks = lattice.CELL_CHUNK, lattice.RESIDUAL_CHUNK
    lattice.CELL_CHUNK = lattice.RESIDUAL_CHUNK = 1 << 62
    try:
        yield
    finally:
        lattice.CELL_CHUNK, lattice.RESIDUAL_CHUNK = chunks


def _batched_coarsen(jac, P_embed):
    with _batched():
        from cracks_tpu_torch.solvers import lattice
        return lattice.coarsen(jac, P_embed)


def main(dev):
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.ops import physics
    from cracks_tpu_torch.parallel import sharding
    from cracks_tpu_torch.solvers import lattice
    for dim, refine in ((2, 3), (2, 6), (3, 1)):
        prm = config.load_parameters(
            os.path.join(ROOT, "params", f"parameters_sneddon_{dim}d.prm"),
            n_global_pre_refine=refine, n_local_pre_refine=0,
            n_refinement_cycles=0, max_no_timesteps=0, linear_solver="cg",
            preconditioner="gmg", mixed_precision_cg=True, output_dir="")
        sim = Simulation(prm, device=dev, verbose=False)
        sim.setup_system()
        sim.determine_mesh_dependent_parameters()
        sim._set_context()
        sys_ = sim.sys
        grid = sys_.lattice_hierarchy.grid
        gen = torch.Generator().manual_seed(1)
        f64 = dict(dtype=torch.float64)
        U = (torch.randn((dim,) + grid, generator=gen, **f64)
             * 1e-3).to(dev)
        P = (torch.rand((1,) + grid, generator=gen, **f64) * 0.5
             + 0.5).to(dev)
        X = torch.randn((dim,) + grid, generator=gen,
                        dtype=torch.float32).to(dev)
        perm = sys_._lattice_lay.cell_perm.reshape(
            tuple(g - 1 for g in grid))
        kw = dict(dim=dim, with_split=False, monolithic=False)
        nb = 2 ** dim * dim
        G = grid[0]

        def all_of(e0, e1):
            """Everything on the rows [e0, e1) and their cells."""
            ca = physics.cell_arrays_from_core(
                sys_._core, torch.float64, perm=perm[e0:e1 - 1].reshape(-1))
            st = (U[:, e0:e1], P[:, e0:e1], P[:, e0:e1], P[:, e0:e1])
            J = lattice.element_matrices_lattice(*st, ca, sys_.scalars,
                                                 rows=G, **kw)
            with _batched():
                JB = lattice.element_matrices_lattice(*st, ca, sys_.scalars,
                                                      **kw)
                RB = torch.cat(lattice.lattice_residual(
                    *st, ca, sys_.scalars, **kw))
            J32 = J.to(torch.float32)
            c0 = e0 % 2
            c1 = (e1 - 1 - e0) - (e1 - 1 - e0 - c0) % 2
            blk = J32[:nb, :nb].abs()
            ordered_rs = blk[:, 0]
            for j in range(1, nb):
                ordered_rs = ordered_rs + blk[:, j]
            Xs = X[:, e0:e1].contiguous()
            # (tensor, its row axis, the global index of its first row,
            # the complete rows [lo, hi))
            vert = (1, e0, e0 + (e0 > 0), e1 - (e1 < G))
            cell = (e0, 0, G)
            return dict(
                matrices=(J, 2) + cell,
                batched_matrices=(JB, 2) + cell,
                residual=(torch.cat(lattice.lattice_residual(
                    *st, ca, sys_.scalars, rows=G, **kw)),) + vert,
                batched_residual=(RB,) + vert,
                coarsen=(lattice.coarsen(J32[:, :, c0:c1].contiguous(),
                                         sys_.lattice_hierarchy.P_embed,
                                         (G - 1) // 2),
                         2, (e0 + c0) // 2, 0, G),
                batched_coarsen=(_batched_coarsen(
                    J32[:, :, c0:c1].contiguous(),
                    sys_.lattice_hierarchy.P_embed),
                    2, (e0 + c0) // 2, 0, G),
                dot_row_sums=(sharding.row_sums((Xs, Xs), a=e0, g=G), 1,
                              0, e0, e1),
                row_sums=(blk.sum(dim=1), 1) + cell,
                ordered_row_sums=(ordered_rs, 1) + cell,
                u_product=(lattice.matvec(J32, Xs, 0, nb, dim),) + vert,
                phi_product=(lattice.matvec(J32, Xs[:1].contiguous(), nb,
                                            nb + 2 ** dim, 1),) + vert)

        ca_all = physics.cell_arrays_from_core(sys_._core, torch.float64,
                                               perm=perm.reshape(-1))
        st = (U, P, P, P)
        times = {}
        mats = lambda: lattice.element_matrices_lattice(
            *st, ca_all, sys_.scalars, **kw)
        res = lambda: lattice.lattice_residual(*st, ca_all, sys_.scalars,
                                               **kw)
        for name, fn, batched in (
                ("element matrices", mats, False),
                ("batched element matrices", mats, True),
                ("residual", res, False),
                ("batched residual", res, True)):
            with _batched() if batched else contextlib.nullcontext():
                fn()
                if dev == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                times[name] = _timed(dev, fn)[1]
                if dev == "cuda":
                    times[name + " peak GB"] = (
                        torch.cuda.max_memory_allocated() / 1e9)
        print(f"{dim}d refine {refine} on {dev}: "
              + ", ".join(f"{k} {v:.3f}" + ("" if "GB" in k else " s")
                           for k, v in times.items()))
        whole = all_of(0, G)
        for e0, e1 in ((0, G // 2 + 1), (G // 2 - 1, G),
                       (G // 4, 3 * G // 4)):
            part = all_of(e0, e1)
            same = {}
            for key, (y, axis, first, lo, hi) in part.items():
                ref = whole[key][0]
                a0, a1 = max(first, lo), min(first + y.shape[axis], hi)
                same[key] = torch.equal(
                    y.narrow(axis, a0 - first, a1 - a0),
                    ref.narrow(axis, a0, a1 - a0))
            print(f"  rows [{e0}, {e1}) of {G}: bit-equal to the whole "
                  "lattice's: " + ", ".join(f"{k} {v}"
                                             for k, v in same.items()),
                  flush=True)
        del sim, whole, part
        if dev == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
