"""The dense direct solve of the Newton system (torch).

Port of the direct path of ``cracks_tpu/solvers/linear.py`` (the
reference's Amesos direct solve, cracks.cc:2750-2758): the element
Jacobians scatter-added into a dense f64 matrix A, the dense constraint
matrix C (identity on free dofs, Q1 interpolation rows for hanging
children, constrained columns zeroed -- AffineConstraints::close()
semantics), an LU factorization of C^T A C + I_constrained
(``torch.linalg``: cuSOLVER on the card) and x = C x_red.  The scatter
is deterministic (`ops.scatter`), so a card run gives the same factor
every time.

The global dof numbering is [u dofs | phi dofs + n_v*dim].
"""

from __future__ import annotations

import torch

from ..ops import physics
from ..ops.constraints import Constraints
from ..ops.scatter import scatter_add, scatter_table

# Dense direct solves above this size would need multi-GB (n, n)
# temporaries; linear_solver = auto takes the Krylov path above it
# (cracks_tpu/solvers/linear.py:48).
DENSE_DIRECT_MAX_DOFS = 8000


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


def _direct_dense_solve(u, phi, phi_old, phi_oold, ca, sc, con, active,
                        rhs_u, rhs_p, *, dim, with_split, monolithic):
    """(du, dp, min |U_ii|, max |U_ii|) of the reduced dense solve."""
    n_ud = u.shape[0]
    n = n_ud + phi.shape[0]
    jac = physics.element_matrices(
        u, phi, phi_old, phi_oold, ca, sc, dim=dim, with_split=with_split,
        monolithic=monolithic).permute(2, 0, 1)          # (n_c, ndl, ndl)
    gids = torch.cat([ca.gather_u.T, ca.gather_p.T + n_ud], dim=1)
    keys = gids[:, :, None] * n + gids[:, None, :]
    A = scatter_add(scatter_table(keys), jac,
                    u.new_zeros(n * n)).view(n, n)
    del jac, keys
    C, constrained = _constraint_matrix(con, active, n_ud, u.dtype)
    A_red = C.T @ (A @ C)
    del A
    A_red.diagonal().add_(constrained.to(u.dtype))
    lu, piv, _ = torch.linalg.lu_factor_ex(A_red)
    del A_red
    b = torch.cat([rhs_u, rhs_p])[:, None]
    x = (C @ torch.linalg.lu_solve(lu, piv, b))[:, 0]
    udiag = lu.diagonal().abs()
    return x[:n_ud], x[n_ud:], udiag.min(), udiag.max()


def solve_direct(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                 sc: physics.Scalars, con: Constraints, active,
                 rhs_u, rhs_p, *, dim: int, with_split: bool,
                 monolithic: bool):
    """Exact dense solve of the reduced Newton system.

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
        dim=dim, with_split=with_split, monolithic=monolithic)
    umin, umax = float(umin), float(umax)
    if not (umax < float("inf") and 0.0 < umin < float("inf")):
        raise DirectSolveRefused("singular factor in dense direct solve")
    return du, dp, 1
