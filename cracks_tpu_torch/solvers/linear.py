"""The dense direct solve and the matrix-free block CG of the Newton
system (torch).

Port of ``cracks_tpu/solvers/linear.py``.

The direct path (the reference's Amesos direct solve,
cracks.cc:2750-2758): the element
Jacobians scatter-added into a dense f64 matrix A, the dense constraint
matrix C (identity on free dofs, Q1 interpolation rows for hanging
children, constrained columns zeroed -- AffineConstraints::close()
semantics), an LU factorization of C^T A C + I_constrained
(``torch.linalg``: LAPACK on the CPU, cuSOLVER on the card, there
followed by two steps of iterative refinement) and x = C x_red.

The PDAS line search accepts a step when its residual is below the last
one (cracks.cc:2940-2957), and near convergence both sit at the
assembly's rounding floor, so the solve's last bits choose the steps
and, through them, the final active set.  On the CPU the solve is
LAPACK's, as in the JAX package, and the two packages take the same
steps.  cuSOLVER's factor rounds otherwise: unrefined, the card ended
`threepoint_1`'s first split step on another active set (bulk energy
2e-5 off the golden); refined once, it took one Newton iteration fewer
on step 1 of the shipped Miehe shear file (crack energy 1.2e-4 off the
JAX table); refined twice, it meets the four goldens and that table.
Refining on the CPU too moves it off the JAX package's steps
(`threepoint_1`'s prefix 1.8e-4 off the JAX run with two steps).  The
scatter is deterministic (`ops.scatter`), so a card run gives the same
factor every time.

The matrix-free path (``assembled_matvec = False``): the
quasi-monolithic Jacobian is block lower triangular (the u rows do not
couple to phi columns, since pf_extra is extrapolated,
cracks.cc:2353-2366), so the solve is A_uu du = b_u, then
A_pp dp = b_p - A_pu du, each by preconditioned CG whose every
iteration applies the condensed block through one jvp of the residual
(`physics.jacobian_vector_product`): `solve_cg_block` with the analytic
Jacobi diagonal, `solve_cg_gmg` with the geometric V-cycle
(`multigrid.make_vcycle`) on each block.  The CG keeps the JAX
package's rules: it tests |r|^2 > tol2 before every iteration (one
host read per iteration), stops at `maxiter`, and returns the last
iterate; there is no stall window, no eps floor on the tolerance and no
least-residual iterate (those belong to the stored-matrix CG,
`solvers/assembled.py`).

The global dof numbering is [u dofs | phi dofs + n_v*dim].
"""

from __future__ import annotations

import math

import torch

from ..ops import physics
from ..ops.constraints import Constraints, condense_residual, expand_update
from ..ops.scatter import WHOLE, CellScatter, scatter_add, scatter_table
from . import multigrid
from .replay import replayer

# Dense direct solves above this size would need multi-GB (n, n)
# temporaries; linear_solver = auto takes the Krylov path above it
# (cracks_tpu/solvers/linear.py:48).
DENSE_DIRECT_MAX_DOFS = 8000
# steps of iterative refinement after cuSOLVER's LU solve (module
# docstring); LAPACK's solve on the CPU is not refined
CARD_REFINEMENT_STEPS = 2


class DirectSolveRefused(RuntimeError):
    """The dense solve does not apply: the system is above the cap, or
    its factor is exactly singular or not finite."""


def _constraint_matrix(con: Constraints, active, n_ud: int, dtype):
    """(C (n, n), constrained (n,) bool) of the homogeneous update
    space."""
    constrained = torch.cat([con.dirichlet_u, con.dirichlet_p | active])
    n = constrained.numel()
    if con.hang_child_u.numel():
        constrained[con.hang_child_u] = True
        constrained[con.hang_child_p + n_ud] = True
    free = (~constrained).to(dtype)
    C = torch.diag(free)
    if con.hang_child_u.numel():
        # C[child, master] += weight, duplicates summed in order
        rows = torch.cat([con.hang_child_u[:, None].expand_as(
                              con.hang_masters_u),
                          (con.hang_child_p + n_ud)[:, None].expand_as(
                              con.hang_masters_p)])
        cols = torch.cat([con.hang_masters_u, con.hang_masters_p + n_ud])
        w = torch.cat([con.hang_weights_u, con.hang_weights]).to(dtype)
        keys = rows * n + cols
        scatter_add(scatter_table(keys), w, C.view(-1))
    # drop constrained columns (chains resolve to zero in the
    # homogeneous update space)
    C *= free[None, :]
    return C, constrained


def _reduced_system(u, phi, phi_old, phi_oold, ca, sc, con, active,
                    rhs_u, rhs_p, *, dim, with_split, monolithic,
                    cs=WHOLE):
    """(A_red (n, n), b (n, 1), C (n, n)) of the reduced dense system
    A_red x = b, x in the constrained update space, du/dp = C x.  `ca`
    holds all cells; with the System's CellScatter `cs` this process
    builds the element matrices of its cells and gathers every
    process's (`CellScatter.all_cells`), so that each rank of the
    replicated cell-axis mode assembles and factors the same matrix."""
    n_ud = u.shape[0]
    n = n_ud + phi.shape[0]
    (jac,) = cs.all_cells(physics.element_matrices(
        u, phi, phi_old, phi_oold, cs.own(ca), sc, dim=dim,
        with_split=with_split, monolithic=monolithic, cs=cs))
    jac = jac.permute(2, 0, 1)                           # (n_c, ndl, ndl)
    gids = torch.cat([ca.gather_u.T, ca.gather_p.T + n_ud], dim=1)
    keys = gids[:, :, None] * n + gids[:, None, :]
    A = scatter_add(scatter_table(keys), jac,
                    u.new_zeros(n * n)).view(n, n)
    del jac, keys
    C, constrained = _constraint_matrix(con, active, n_ud, u.dtype)
    A_red = C.T @ (A @ C)
    del A
    A_red.diagonal().add_(constrained.to(u.dtype))
    return A_red, torch.cat([rhs_u, rhs_p])[:, None], C


def _lu_solve(A_red, b, refinements):
    """(x, LU factor) of A_red x = b: the LU solve followed by
    `refinements` steps of iterative refinement."""
    lu, piv, _ = torch.linalg.lu_factor_ex(A_red)
    x = torch.linalg.lu_solve(lu, piv, b)
    for _ in range(refinements):
        x = x + torch.linalg.lu_solve(lu, piv, b - A_red @ x)
    return x, lu


def _direct_dense_solve(u, phi, phi_old, phi_oold, ca, sc, con, active,
                        rhs_u, rhs_p, *, dim, with_split, monolithic,
                        cs=WHOLE):
    """(du, dp, min |U_ii|, max |U_ii|) of the reduced dense solve."""
    A_red, b, C = _reduced_system(
        u, phi, phi_old, phi_oold, ca, sc, con, active, rhs_u, rhs_p,
        dim=dim, with_split=with_split, monolithic=monolithic, cs=cs)
    x, lu = _lu_solve(A_red, b,
                      CARD_REFINEMENT_STEPS if A_red.is_cuda else 0)
    del A_red
    x = (C @ x)[:, 0]
    udiag = lu.diagonal().abs()
    n_ud = u.shape[0]
    return x[:n_ud], x[n_ud:], udiag.min(), udiag.max()


def solve_direct(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                 sc: physics.Scalars, con: Constraints, active,
                 rhs_u, rhs_p, *, dim: int, with_split: bool,
                 monolithic: bool, cs=WHOLE):
    """Exact dense solve of the reduced Newton system (`ca`: all cells;
    with the System's CellScatter `cs`, see `_reduced_system`).

    Returns (du (n_v*dim,), dp (n_v,), 1) with the constraints
    distributed.  Raises DirectSolveRefused above DENSE_DIRECT_MAX_DOFS
    or on an exactly singular or non-finite factor (the caller then
    takes the Krylov path, whose iterates stay in the range space -- the
    role of the reference's GMRES, cracks.cc:2762-2771)."""
    n_dofs = u.shape[0] + phi.shape[0]
    if n_dofs > DENSE_DIRECT_MAX_DOFS:
        raise DirectSolveRefused(
            f"dense direct solve capped at {DENSE_DIRECT_MAX_DOFS} DoFs "
            f"(got {n_dofs}); use the Krylov path")
    du, dp, umin, umax = _direct_dense_solve(
        u, phi, phi_old, phi_oold, ca, sc, con, active, rhs_u, rhs_p,
        dim=dim, with_split=with_split, monolithic=monolithic, cs=cs)
    umin, umax = float(umin), float(umax)
    if not (umax < float("inf") and 0.0 < umin < float("inf")):
        raise DirectSolveRefused("singular factor in dense direct solve")
    return du, dp, 1


# ---------------------------------------------------------------------------
# the matrix-free path
# ---------------------------------------------------------------------------

def _pcg(op, b, M, rtol, atol, maxiter: int):
    """Preconditioned CG from x = 0 for op x = b with the
    preconditioner application M; returns (x, iterations).  Iterates
    while |r|^2 > max(rtol |b|, atol)^2 (the comparison in b's dtype)
    and fewer than `maxiter` iterations were taken, reading |r|^2 once
    per iteration.  Each iteration updates the state in place; on a
    CUDA tensor the iterations from the second on replay a CUDA graph
    of the first (`replay.replayer`)."""
    tol2 = max(rtol * math.sqrt(float(torch.dot(b, b))), atol) ** 2
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = torch.dot(r, z)
    rr = torch.dot(r, r)

    def step():
        Ap = op(p)
        denom = torch.dot(p, Ap)
        alpha = torch.where(denom != 0, rz / denom, 0.0)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        p.mul_(beta).add_(z)            # z + beta p
        rz.copy_(rz_new)
        rr.copy_(torch.dot(r, r))

    run = replayer(step, b.is_cuda)
    k = 0
    while k < maxiter and bool(rr > tol2):
        run()
        k += 1
    return x, k


def chunked_maxiter(maxiter: int, chunk: int) -> int:
    """The iteration cap of the JAX package's chunked CG
    (``solve_cg_block_chunked``), which tests `maxiter` only between
    chunks of `chunk` iterations: `maxiter` rounded up to a multiple of
    `chunk`."""
    return -(-maxiter // chunk) * chunk


def _block_ops(u, phi, phi_old, phi_oold, ca, sc, cs: CellScatter,
               con: Constraints, active, *, dim, with_split, monolithic):
    """(jv, op_u, op_p): the condensed Jacobian action on a free-subspace
    pair (expand, jvp, condense) and its two diagonal blocks."""
    zero_p = torch.zeros_like(phi)
    zero_u = torch.zeros_like(u)

    def jv(du, dp):
        eu, ep = expand_update(du, dp, con, active)
        ju, jp = physics.jacobian_vector_product(
            u, phi, eu, ep, phi_old, phi_oold, ca, sc, cs, dim=dim,
            with_split=with_split, monolithic=monolithic)
        return condense_residual(ju, jp, con, active)

    return jv, (lambda x: jv(x, zero_p)[0]), (lambda x: jv(zero_u, x)[1])


def _jacobi_inverses(con: Constraints, active, diag_u, diag_p):
    """(Dinv_u, Dinv_p, zero_u, zero_p): the Jacobi inverses on the free
    dofs (1 elsewhere) and the constrained-dof masks."""
    zero_u = con.dirichlet_u | con.hang_mask_u
    zero_p = con.dirichlet_p | con.hang_mask_p | active
    Dinv_u = torch.where(~zero_u & (diag_u.abs() > 0), 1.0 / diag_u, 1.0)
    Dinv_p = torch.where(~zero_p & (diag_p.abs() > 0), 1.0 / diag_p, 1.0)
    return Dinv_u, Dinv_p, zero_u, zero_p


def solve_cg_block(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                   sc: physics.Scalars, cs: CellScatter, con: Constraints,
                   active, rhs_u, rhs_p, diag_u, diag_p, rtol, atol, *,
                   dim: int, with_split: bool, monolithic: bool,
                   maxiter: int):
    """The matrix-free block-triangular solve with Jacobi CG on each
    block (diag_u/diag_p: the Jacobi diagonals; their entries at
    constrained dofs are ignored).  Returns (du, dp, iterations) with
    the constraints distributed."""
    jv, op_u, op_p = _block_ops(u, phi, phi_old, phi_oold, ca, sc, cs, con,
                                active, dim=dim, with_split=with_split,
                                monolithic=monolithic)
    Dinv_u, Dinv_p, _, _ = _jacobi_inverses(con, active, diag_u, diag_p)
    du, it_u = _pcg(op_u, rhs_u, lambda r: Dinv_u * r, rtol, atol, maxiter)
    _, b_coupled = jv(du, torch.zeros_like(phi))
    dp, it_p = _pcg(op_p, rhs_p - b_coupled, lambda r: Dinv_p * r, rtol,
                    atol, maxiter)
    du, dp = expand_update(du, dp, con, active)
    return du, dp, it_u + it_p


def _level_block_ops(u, phi, phi_old, phi_oold, ca, sc, cs, con, active,
                     *, dim, with_split, monolithic):
    """One geometric level's (jv, op_u, op_p, Dinv_u, Dinv_p, zero_u,
    zero_p), each block operator masked to its free subspace on input
    and output."""
    jv, op_u, op_p = _block_ops(u, phi, phi_old, phi_oold, ca, sc, cs, con,
                                active, dim=dim, with_split=with_split,
                                monolithic=monolithic)
    diag_u, diag_p = physics.jacobi_diagonal_approx(
        u, phi, phi_old, phi_oold, ca, sc, cs, dim=dim,
        monolithic=monolithic)
    Dinv_u, Dinv_p, zm_u, zm_p = _jacobi_inverses(con, active, diag_u,
                                                  diag_p)

    def masked(op, zm):
        return lambda x: torch.where(zm, 0.0, op(torch.where(zm, 0.0, x)))

    return (jv, masked(op_u, zm_u), masked(op_p, zm_p), Dinv_u, Dinv_p,
            zm_u, zm_p)


def _level_states(hierarchy: multigrid.Hierarchy, u, phi, phi_old,
                  phi_oold):
    """Each level's (u, phi, phi_old, phi_oold), coarsest first: the
    fine state restricted down the chain by full weighting, normalized
    by the restricted ones (injection would misrepresent the crack's
    degraded coefficient on the coarse levels)."""
    levels = hierarchy.levels
    transfers = [*levels[1:], hierarchy]
    chain = []
    state = (u, phi, phi_old, phi_oold)
    for lvl, t in zip(levels[::-1], transfers[::-1]):
        def down(x, which):
            args = (getattr(t, f"masters_{which}"),
                    getattr(t, f"weights_{which}"),
                    getattr(t, f"scatter_{which}"),
                    getattr(lvl, f"inject_{which}").shape[0])
            return (multigrid._restrict(x, *args)
                    / multigrid._restrict(torch.ones_like(x), *args))

        state = (down(state[0], "u"), *(down(f, "p") for f in state[1:]))
        chain.insert(0, state)
    return chain


def solve_cg_gmg(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                 sc: physics.Scalars, cs: CellScatter, con: Constraints,
                 active, rhs_u, rhs_p, hierarchy: multigrid.Hierarchy,
                 rtol, atol, *, dim: int, with_split: bool, monolithic: bool,
                 maxiter: int, degree: int = multigrid.VCYCLE_DEGREE):
    """The matrix-free block-triangular solve with the geometric
    V-cycle preconditioning CG on each block.  The level operators are
    jvps of each level's residual at the restricted state, with the
    level's own constraints and the active set injected from the fine
    vertices.  Returns (du, dp, iterations) with the constraints
    distributed."""
    kw = dict(dim=dim, with_split=with_split, monolithic=monolithic)
    jv, *fine = _level_block_ops(u, phi, phi_old, phi_oold, ca, sc, cs, con,
                                 active, **kw)
    per_level = []
    for lvl, (ul, pl, pol, pool) in zip(
            hierarchy.levels, _level_states(hierarchy, u, phi, phi_old,
                                            phi_oold)):
        per_level.append(_level_block_ops(
            ul, pl, pol, pool, lvl.ca, sc, lvl.cs, lvl.con,
            active[lvl.inject_p], **kw)[1:])
    per_level.append(fine)
    transfers = [*hierarchy.levels[1:], hierarchy]
    n_dofs = ([(lvl.inject_u.shape[0], lvl.inject_p.shape[0])
               for lvl in hierarchy.levels] + [(u.shape[0], phi.shape[0])])

    def block(which):
        i = 0 if which == "u" else 1
        ops = [lv[i] for lv in per_level]
        Dinvs = [lv[2 + i] for lv in per_level]
        lams = [multigrid._power_lambda_max(op, Dinv, torch.ones_like(Dinv))
                for op, Dinv in zip(ops, Dinvs)]
        return multigrid.GMGBlock(
            ops=tuple(ops), Dinvs=tuple(Dinvs), lam_maxes=tuple(lams),
            masters=(None, *(getattr(t, f"masters_{which}")
                             for t in transfers)),
            weights=(None, *(getattr(t, f"weights_{which}")
                             for t in transfers)),
            scatters=(None, *(getattr(t, f"scatter_{which}")
                              for t in transfers)),
            n_dofs=tuple(n[i] for n in n_dofs),
            zmasks=tuple(lv[4 + i] for lv in per_level))

    block_u = block("u")
    block_p = block("p")
    M_u = multigrid.make_vcycle(block_u, degree=degree)
    M_p = multigrid.make_vcycle(block_p, degree=degree)
    du, it_u = _pcg(block_u.ops[-1], rhs_u, M_u, rtol, atol, maxiter)
    _, b_coupled = jv(du, torch.zeros_like(phi))
    dp, it_p = _pcg(block_p.ops[-1], rhs_p - b_coupled, M_p, rtol, atol,
                    maxiter)
    du, dp = expand_update(du, dp, con, active)
    return du, dp, it_u + it_p
