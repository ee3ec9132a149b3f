"""Stored-element-matrix Krylov operator (torch).

Port of ``cracks_tpu/solvers/assembled.py``: the per-cell dense Newton
Jacobians (ndl x ndl, ndl = 2^dim*(dim+1), cell axis last) are built
once per Newton iteration, and every Krylov iteration is then

    gather (ndl, n_c) -> batched dense (ndl x ndl) matvec -> scatter-add

the analogue of the reference's "assemble once, matvec many" Trilinos
matrix (cracks.cc:2129-2498 assembly, 2762-2771 solve).  The scatter
(`ops.scatter.CellScatter`, built once per mesh epoch) is
deterministic, so a card run repeats its iterates bit for bit.

Block structure: the quasi-monolithic Jacobian is block lower
triangular (u rows do not couple to phi columns, cracks.cc:2353-2366),
so A_uu = J[:nud_l, :nud_l], A_pu = J[nud_l:, :nud_l] and
A_pp = J[nud_l:, nud_l:] are slices of the same stored array, and the
solve is a pair of Jacobi-preconditioned CGs: A_uu du = b_u, then
A_pp dp = b_p - A_pu du.

The JAX package advances each CG in host-driven chunks of device
iterations; here the loop is on the host, one iteration at a time,
with the same stopping rules: the first iteration with |r|^2 <= tol2
(or a non-finite one), `maxiter`, or two consecutive windows of
`stall_window` iterations (the JAX chunk, ``cg_chunk``) that do not
halve the least |r|^2 so far.  The iterate of least |r|^2 is
returned.
"""

from __future__ import annotations

import math

import torch

from ..ops import physics
from ..ops.constraints import (Constraints, hanging_interpolate_p,
                               hanging_interpolate_u, hanging_transpose_p,
                               hanging_transpose_u)
from ..ops.scatter import CellScatter, scatter_add


def build_jacobians(u, phi, phi_old, phi_oold, ca: physics.CellArrays,
                    sc: physics.Scalars, *, dim: int, with_split: bool,
                    monolithic: bool):
    """(ndl, ndl, n_c) cell-last element Jacobians at the current
    Newton linearization point."""
    return physics.element_matrices(
        u, phi, phi_old, phi_oold, ca, sc, dim=dim, with_split=with_split,
        monolithic=monolithic)


# ---------------------------------------------------------------------------
# raw block matvecs (no constraints)
# ---------------------------------------------------------------------------

def _block_apply(jac_blk, xe):
    return torch.einsum("ijc,jc->ic", jac_blk, xe)


def matvec_uu(jac_cl, ca: physics.CellArrays, x, cs: CellScatter, *,
              dim: int):
    nud_l = ca.gather_p.shape[0] * dim
    ye = _block_apply(jac_cl[:nud_l, :nud_l], x[ca.gather_u])
    return scatter_add(cs.u, ye, x.new_zeros(cs.n_ud))


def matvec_pp(jac_cl, ca: physics.CellArrays, x, cs: CellScatter, *,
              dim: int):
    nud_l = ca.gather_p.shape[0] * dim
    ye = _block_apply(jac_cl[nud_l:, nud_l:], x[ca.gather_p])
    return scatter_add(cs.p, ye, x.new_zeros(cs.n_p))


def matvec_pu(jac_cl, ca: physics.CellArrays, xu, cs: CellScatter, *,
              dim: int):
    """Coupling block action: phi rows, u columns (B du)."""
    nud_l = ca.gather_p.shape[0] * dim
    ye = _block_apply(jac_cl[nud_l:, :nud_l], xu[ca.gather_u])
    return scatter_add(cs.p, ye, xu.new_zeros(cs.n_p))


def diagonals(jac_cl, ca: physics.CellArrays, cs: CellScatter, *,
              dim: int):
    """Exact global Jacobi diagonals (du (n_ud,), dp (n_p,)) from the
    stored element matrices."""
    nud_l = ca.gather_p.shape[0] * dim
    d_loc = jac_cl.diagonal(dim1=0, dim2=1).T               # (ndl, c)
    du = scatter_add(cs.u, d_loc[:nud_l], jac_cl.new_zeros(cs.n_ud))
    dp = scatter_add(cs.p, d_loc[nud_l:], jac_cl.new_zeros(cs.n_p))
    return du, dp


# ---------------------------------------------------------------------------
# condensed block operators (hanging + Dirichlet + active set)
# ---------------------------------------------------------------------------

def free_masks(con: Constraints, active):
    """(free_u, free_p): the dofs of the reduced update space."""
    return (~(con.dirichlet_u | con.hang_mask_u),
            ~(con.dirichlet_p | con.hang_mask_p | active))


def make_condensed_ops(jac_cl, ca: physics.CellArrays, con: Constraints,
                       active, cs: CellScatter, *, dim: int):
    """(op_u, op_p, op_pu): the condensed block actions on the free
    subspace, each expand -> raw matvec -> condense (the C^T A C
    reduction of the direct solve)."""
    free_u, free_p = free_masks(con, active)

    def op_u(x):
        x = hanging_interpolate_u(torch.where(free_u, x, 0.0), con)
        y = hanging_transpose_u(matvec_uu(jac_cl, ca, x, cs, dim=dim), con)
        return torch.where(free_u, y, 0.0)

    def op_p(x):
        x = hanging_interpolate_p(torch.where(free_p, x, 0.0), con)
        y = hanging_transpose_p(matvec_pp(jac_cl, ca, x, cs, dim=dim), con)
        return torch.where(free_p, y, 0.0)

    def op_pu(xu):
        xu = hanging_interpolate_u(torch.where(free_u, xu, 0.0), con)
        y = hanging_transpose_p(matvec_pu(jac_cl, ca, xu, cs, dim=dim), con)
        return torch.where(free_p, y, 0.0)

    return op_u, op_p, op_pu


def residual_update(jac_cl, ca, con, active, cs: CellScatter, du, dp,
                    rhs_u, rhs_p, *, dim: int):
    """(rhs - J x) on the free subspace for a free-subspace update
    (du, dp): the iterative-refinement correction right-hand side."""
    op_u, op_p, op_pu = make_condensed_ops(jac_cl, ca, con, active, cs,
                                           dim=dim)
    return rhs_u - op_u(du), rhs_p - op_pu(du) - op_p(dp)


def _coupling_rhs(jac_cl, ca, con, active, cs: CellScatter, du, rhs_p, *,
                  dim: int):
    _, _, op_pu = make_condensed_ops(jac_cl, ca, con, active, cs, dim=dim)
    return rhs_p - op_pu(du)


# ---------------------------------------------------------------------------
# Jacobi PCG on one block
# ---------------------------------------------------------------------------

def _pcg(op, b, Minv, tol2: float, maxiter: int, stall_window: int):
    """Jacobi PCG from x = 0; returns (the iterate of least |r|^2, its
    iteration count).  Stops at the first iteration with |r|^2 <= tol2
    or non-finite, at `maxiter`, or after two consecutive windows of
    `stall_window` iterations that did not halve the least |r|^2 so far
    (Jacobi CG on the fracture operator can plateau for a while, so one
    such window is not proof of stagnation)."""
    rr = float(torch.dot(b, b))
    x = torch.zeros_like(b)
    r = b
    z = Minv * b
    pvec = z
    rz = torch.dot(b, z)
    xb = torch.zeros_like(b)
    rrb = torch.as_tensor(rr, dtype=b.dtype, device=b.device)
    k = 0
    stalls = 0
    window_rrb = rr
    while rr > tol2 and k < maxiter:
        Ap = op(pvec)
        denom = torch.dot(pvec, Ap)
        alpha = torch.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rr_d = torch.dot(r, r)
        better = rr_d < rrb
        xb = torch.where(better, x, xb)
        rrb = torch.where(better, rr_d, rrb)
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        rz = rz_new
        k += 1
        rr = float(rr_d)
        if k % stall_window == 0 and rr > tol2:
            best = float(rrb)
            stalls = stalls + 1 if best > 0.5 * window_rrb else 0
            window_rrb = best
            if stalls >= 2:
                break
    return xb, k


def solve_cg_block(jac_cl, ca, con, active, rhs_u, rhs_p, diag_u, diag_p,
                   rtol, atol, cs: CellScatter, *, dim: int, maxiter: int,
                   stall_window: int):
    """Block-triangular stored-matrix CG: A_uu du = b_u, then
    A_pp dp = b_p - A_pu du, each by Jacobi PCG.

    Returns (du, dp, iterations) on the FREE subspace (the caller
    expands)."""
    free_u, free_p = free_masks(con, active)
    Minv_u = torch.where(free_u & (diag_u.abs() > 0), 1.0 / diag_u, 1.0)
    Minv_p = torch.where(free_p & (diag_p.abs() > 0), 1.0 / diag_p, 1.0)
    op_u, op_p, _ = make_condensed_ops(jac_cl, ca, con, active, cs, dim=dim)
    eps = torch.finfo(jac_cl.dtype).eps

    def run_block(op, b, Minv):
        bnorm = math.sqrt(float(torch.dot(b, b)))
        # floor at ~100 eps relative: below that CG stagnates on
        # rounding noise and the iterate can drift to huge magnitudes
        # while chasing an unreachable tolerance
        tol2 = max(rtol * bnorm, atol, 100.0 * eps * bnorm) ** 2
        return _pcg(op, b, Minv, tol2, maxiter, stall_window)

    du, it_u = run_block(op_u, rhs_u, Minv_u)
    rhs_p2 = _coupling_rhs(jac_cl, ca, con, active, cs, du, rhs_p, dim=dim)
    dp, it_p = run_block(op_p, rhs_p2, Minv_p)
    return du, dp, it_u + it_p
