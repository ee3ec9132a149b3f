"""Constraint handling: hanging nodes, Dirichlet masks, active-set masks.

Port of ``cracks_tpu/ops/constraints.py`` (deal.II AffineConstraints,
reference cracks.cc:1630-1642, 2439-2464).  Solution layout is flat: u
is (n_v*dim,) with dof index vertex*dim + component, phi is (n_v,).

All constraints of the Newton update system are homogeneous (the
inhomogeneous boundary values are written into the solution directly,
cracks.cc:2699-2707), so

 * distribute  == set children from masters, zero the masked dofs
 * distribute_local_to_global residual == scatter, then add each hanging
   child's residual row to its masters and zero the child
 * set_zero    == zero all constrained rows.

Every function is out-of-place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Constraints(NamedTuple):
    """Device-side constraint data (flat dof indexing).  The hanging
    arrays exist per phi vertex and expanded per u dof."""

    hang_child_p: torch.Tensor    # (n_h,) int64 phi dofs
    hang_masters_p: torch.Tensor  # (n_h, 4) int64
    hang_child_u: torch.Tensor    # (n_h*dim,) int64 u dofs
    hang_masters_u: torch.Tensor  # (n_h*dim, 4) int64
    hang_weights: torch.Tensor    # (n_h, 4)
    hang_weights_u: torch.Tensor  # (n_h*dim, 4)
    dirichlet_u: torch.Tensor     # (n_v*dim,) bool
    dirichlet_p: torch.Tensor     # (n_v,) bool
    hang_mask_u: torch.Tensor     # (n_v*dim,) bool
    hang_mask_p: torch.Tensor     # (n_v,) bool


def make_constraints(mesh, dirichlet_u: np.ndarray, dirichlet_p: np.ndarray,
                     *, dtype: torch.dtype, device) -> Constraints:
    """dirichlet_u: (n_v, dim) bool vertex/component mask."""
    dim = mesh.dim
    n_v = mesh.n_vertices
    child = mesh.hang_child.astype(np.int64)
    masters = mesh.hang_masters.astype(np.int64)
    weights = mesh.hang_weights
    comp = np.arange(dim)
    child_u = (child[:, None] * dim + comp[None, :]).reshape(-1)
    masters_u = (masters[:, None, :] * dim
                 + comp[None, :, None]).reshape(-1, masters.shape[1])
    weights_u = np.repeat(weights, dim, axis=0)
    hm_p = np.zeros(n_v, dtype=bool)
    hm_p[child] = True
    hm_u = np.zeros(n_v * dim, dtype=bool)
    hm_u[child_u] = True
    i64 = dict(dtype=torch.int64, device=device)
    flt = dict(dtype=dtype, device=device)
    b = dict(dtype=torch.bool, device=device)
    return Constraints(
        hang_child_p=torch.as_tensor(child, **i64),
        hang_masters_p=torch.as_tensor(masters, **i64),
        hang_child_u=torch.as_tensor(child_u, **i64),
        hang_masters_u=torch.as_tensor(masters_u, **i64),
        hang_weights=torch.as_tensor(weights, **flt),
        hang_weights_u=torch.as_tensor(weights_u, **flt),
        dirichlet_u=torch.as_tensor(
            np.asarray(dirichlet_u).reshape(-1), **b),
        dirichlet_p=torch.as_tensor(np.asarray(dirichlet_p), **b),
        hang_mask_u=torch.as_tensor(hm_u, **b),
        hang_mask_p=torch.as_tensor(hm_p, **b),
    )


def _interp(x, child, masters, weights):
    if child.numel() == 0:
        return x
    vals = torch.einsum("hm,hm->h", weights.to(x.dtype), x[masters])
    return x.index_put((child,), vals)


def _transpose(r, child, masters, weights):
    if child.numel() == 0:
        return r
    child_vals = r[child]
    r = r.index_add(0, masters.reshape(-1),
                    (weights.to(r.dtype) * child_vals[:, None]).reshape(-1))
    return r.index_fill(0, child, 0.0)


def hanging_interpolate_u(x, con: Constraints):
    return _interp(x, con.hang_child_u, con.hang_masters_u,
                   con.hang_weights_u)


def hanging_interpolate_p(x, con: Constraints):
    return _interp(x, con.hang_child_p, con.hang_masters_p,
                   con.hang_weights)


def hanging_transpose_u(r, con: Constraints):
    return _transpose(r, con.hang_child_u, con.hang_masters_u,
                      con.hang_weights_u)


def hanging_transpose_p(r, con: Constraints):
    return _transpose(r, con.hang_child_p, con.hang_masters_p,
                      con.hang_weights)


def zero_constrained(ru, rp, con: Constraints, active):
    """constraints.set_zero on the (u, phi) residual pair; `active` is
    the active-set mask over phase-field vertices (n_v,)."""
    ru = torch.where(con.dirichlet_u | con.hang_mask_u, 0.0, ru)
    rp = torch.where(con.dirichlet_p | con.hang_mask_p | active, 0.0, rp)
    return ru, rp


def condense_residual(ru, rp, con: Constraints, active):
    """Reduce a raw assembled residual to the Newton right-hand side:
    hanging condensation, then zeroing of all constrained rows
    (cracks.cc:2442-2443 + set_zero 2918)."""
    ru = hanging_transpose_u(ru, con)
    rp = hanging_transpose_p(rp, con)
    return zero_constrained(ru, rp, con, active)


def expand_update(du, dp, con: Constraints, active):
    """Map a free-dof update into the full space: zero constrained dofs,
    then interpolate hanging children (constraints.distribute on the
    homogeneous Newton update, cracks.cc:2756/2773)."""
    du, dp = zero_constrained(du, dp, con, active)
    return hanging_interpolate_u(du, con), hanging_interpolate_p(dp, con)


def residual_norm(ru, rp) -> torch.Tensor:
    """l2 norm over the combined (u, phi) residual."""
    return torch.sqrt(torch.sum(ru * ru) + torch.sum(rp * rp))


def residual_linfty(ru, rp) -> torch.Tensor:
    return torch.maximum(ru.abs().max(), rp.abs().max())
