"""The quasi-monolithic phase-field fracture element kernel (torch).

Port of ``cracks_tpu/ops/physics.py``.  The residual is batched dense
tensor math over all cells with the cell axis LAST; the Newton matrix
is the exact derivative of that residual, so the element matrices are
``torch.func.jvp``s of the cell-last residual with one-hot tangents.

Layout: ``grads`` is ``(n_q, nvc, dim, n_c)``, per-quadrature scalars
``(n_q, n_c)``; solution vectors are flat — ``u`` is ``(n_v*dim,)``
with dof index ``vertex*dim + component``, ``phi`` is ``(n_v,)``.

Weak form (Heister/Wheeler/Wick 2015), as in the JAX module:

  displacement rows:
      ((1-k) pf_extra^2 + k) sigma+(u) : grad(v)
      + chi_rhs * sigma-(u) : grad(v)
      - (alpha_b - 1) p pf_extra^2 div(v)
  phase-field rows:
      gamma/dt/h^2 max(0, pf - pf_old) w
      + (1-k) (sigma+(u) : E(u)) pf w
      - G_c/eps (1 - pf) w
      + G_c eps grad(pf) . grad(w)
      - 2 (alpha_b - 1) p pf div(u) w

Only the undecomposed stress (``with_split=False``) is ported; the
spectral split raises (ROADMAP A1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import fem
from .scatter import CellScatter, scatter_add

ALPHA_BIOT = 0.0  # reference cracks.cc:1497


class CellArrays(NamedTuple):
    """Per-mesh element data on the device (cell axis LAST)."""

    gather_u: torch.Tensor   # (nvc*dim, n_c) int64 flat u-dof gather map
    gather_p: torch.Tensor   # (nvc, n_c) int64 phi-dof gather map
    JxW: torch.Tensor        # (n_q, n_c)
    grads: torch.Tensor      # (n_q, nvc, dim, n_c) real-space shape grads
    shape_v: torch.Tensor    # (n_q, nvc)
    lam: torch.Tensor        # (n_c,) per-cell Lame lambda
    mu: torch.Tensor         # (n_c,) per-cell Lame mu
    inv_diam2: torch.Tensor  # (n_c,) 1/diameter^2


class Scalars(NamedTuple):
    """Per-solve scalars, 0-d tensors on the device."""

    pressure: torch.Tensor
    constant_k: torch.Tensor
    alpha_eps: torch.Tensor
    G_c: torch.Tensor
    gamma_dt: torch.Tensor
    theta: torch.Tensor        # (dt_old + dt_oold)/dt_oold extrapolation
    use_old_pf: torch.Tensor   # 1.0 -> pf_extra := pf_old (retry mode)
    decompose_rhs: torch.Tensor


def make_scalars(pressure, constant_k, alpha_eps, G_c, gamma_dt, theta,
                 use_old_pf, decompose_rhs, *, dtype: torch.dtype,
                 device) -> Scalars:
    c = lambda v: torch.as_tensor(float(v), dtype=dtype, device=device)
    return Scalars(c(pressure), c(constant_k), c(alpha_eps), c(G_c),
                   c(gamma_dt), c(theta), c(use_old_pf), c(decompose_rhs))


def _straight_through_clamp_below(x):
    """max(0, x) in the residual, identity in the linearization (the
    penalized-monolithic mode's clamp, cracks.cc:2251-2256, which the
    reference's hand Jacobian linearizes as if d(clamp)/d(pf) = 1)."""
    return x + (x.clamp_min(0.0) - x).detach()


def _pf_extra(pf, pf_old, pf_oold, sc: Scalars):
    """Time-lagged extrapolated phase field (cracks.cc:2262-2277)."""
    extra = (pf_oold + sc.theta * (pf_old - pf_oold)).clamp(0.0, 1.0)
    return torch.where(sc.use_old_pf > 0.5, pf_old, extra)


def _full_stress_components(strain, lam, mu, dim):
    """sigma = lam tr(E) I + 2 mu E on a component dict; strain maps
    (i,j) -> (n_q, n_c) tensors for i <= j."""
    tr = sum(strain[(d, d)] for d in range(dim))
    sigma = {}
    for i in range(dim):
        for j in range(i, dim):
            s = 2.0 * mu * strain[(i, j)]
            if i == j:
                s = s + lam * tr
            sigma[(i, j)] = s
    return sigma, tr


def _element_residual_cl(u_e, phi_e, pf_old_e, pf_oold_e, ca: CellArrays,
                         sc: Scalars, *, dim: int, with_split: bool,
                         monolithic: bool):
    """Per-cell residual in the cell-last layout, BEFORE scatter-add.

    u_e (nvc, dim, c); phi_e/pf_old_e/pf_oold_e (nvc, c).
    Returns (ru_e (nvc, dim, c), rp_e (nvc, c))."""
    if with_split:
        raise NotImplementedError("spectral split: ROADMAP A1")
    grad_u = torch.einsum("adc,qaec->qdec", u_e, ca.grads)
    pf = torch.einsum("qa,ac->qc", ca.shape_v, phi_e)
    grad_pf = torch.einsum("ac,qaec->qec", phi_e, ca.grads)
    pf_old = torch.einsum("qa,ac->qc", ca.shape_v, pf_old_e)
    pf_oold = torch.einsum("qa,ac->qc", ca.shape_v, pf_oold_e)

    if monolithic:
        pf = _straight_through_clamp_below(pf)
        pf_old = pf_old.clamp_min(0.0)
        pf_oold = pf_oold.clamp_min(0.0)

    pf_extra = _pf_extra(pf, pf_old, pf_oold, sc)

    strain = {}
    for i in range(dim):
        for j in range(i, dim):
            strain[(i, j)] = 0.5 * (grad_u[:, i, j] + grad_u[:, j, i])
    div_u = sum(grad_u[:, d, d] for d in range(dim))

    sp, _ = _full_stress_components(strain, ca.lam[None, :],
                                    ca.mu[None, :], dim)

    degr = (1.0 - sc.constant_k) * pf_extra**2 + sc.constant_k   # (q, c)
    # sigma- is identically zero without the split, so M = degr sigma+
    M = {k: degr * v for k, v in sp.items()}
    p_term = (ALPHA_BIOT - 1.0) * sc.pressure * pf_extra**2       # (q, c)

    gw = ca.grads * ca.JxW[:, None, None, :]      # (q, a, e, c)
    ru_e = []
    for d in range(dim):
        acc = 0.0
        for e in range(dim):
            key = (min(d, e), max(d, e))
            acc = acc + torch.einsum("qc,qac->ac", M[key], gw[:, :, e, :])
        acc = acc - torch.einsum("qc,qac->ac", p_term, gw[:, :, d, :])
        ru_e.append(-acc)                          # (a, c)
    ru_e = torch.stack(ru_e, dim=1)                # (a, d, c)

    sp_E = sum((1.0 if i == j else 2.0) * sp[(i, j)] * strain[(i, j)]
               for i in range(dim) for j in range(i, dim))
    gap = pf - pf_old
    gap_plus = torch.where(gap < 0.0, 0.0, gap)
    S = (sc.gamma_dt * ca.inv_diam2[None, :] * gap_plus
         + (1.0 - sc.constant_k) * sp_E * pf
         - sc.G_c / sc.alpha_eps * (1.0 - pf)
         - 2.0 * (ALPHA_BIOT - 1.0) * sc.pressure * pf * div_u)   # (q, c)
    SJ = S * ca.JxW
    rp_e = -(torch.einsum("qc,qa->ac", SJ, ca.shape_v)
             + sc.G_c * sc.alpha_eps
             * torch.einsum("qec,qaec->ac", grad_pf, gw))
    return ru_e, rp_e


class CellCore(NamedTuple):
    """Device-resident cell-FIRST geometry core, built once per mesh
    epoch; every CellArrays variant (dtype x cell order) derives from
    it with cell_arrays_from_core."""

    gather_u: torch.Tensor   # (n_c, nvc*dim) int64
    gather_p: torch.Tensor   # (n_c, nvc) int64
    JxW: torch.Tensor        # (n_c, n_q) f64
    grads: torch.Tensor      # (n_c, n_q, nvc, dim) f64
    lam: torch.Tensor        # (n_c,) f64
    mu: torch.Tensor         # (n_c,) f64
    inv_diam2: torch.Tensor  # (n_c,) f64
    shape_v: np.ndarray      # (n_q, nvc) host-side constant


def build_cell_core(mesh, lam, mu, *, device) -> CellCore:
    """Host geometry sweep -> cell-first core on `device`.  On affine
    meshes (every generated rect/cube mesh) only the per-cell affine
    Jacobians go to the device and the gradient tabulation runs there;
    for axis-aligned cells invJ is diagonal, so the e-sum has one
    nonzero term and the result equals the host product exactly."""
    f64 = dict(dtype=torch.float64, device=device)
    t = fem.element_tables(mesh.dim)
    geo = fem.affine_cell_jacobians(mesh.cell_coords, t)
    if geo is not None:
        detJ_c, invJ_c = geo
        grads = torch.einsum("qae,ced->cqad",
                             torch.as_tensor(t.shape_g, **f64),
                             torch.as_tensor(invJ_c, **f64))
        JxW = (torch.as_tensor(detJ_c, **f64)[:, None]
               * torch.as_tensor(t.q_weights, **f64)[None, :])
    else:
        JxW_h, grads_h = fem.cell_geometry(mesh.cell_coords, t)
        JxW = torch.as_tensor(JxW_h, **f64)
        grads = torch.as_tensor(grads_h, **f64)
    dim = mesh.dim
    n_c = mesh.n_cells
    nvc = mesh.cell2vert.shape[1]
    c2v = mesh.cell2vert.astype(np.int64)
    gather_u = (c2v[:, :, None] * dim
                + np.arange(dim)[None, None, :]).reshape(n_c, nvc * dim)
    lam_arr = np.broadcast_to(np.asarray(lam, np.float64), (n_c,))
    mu_arr = np.broadcast_to(np.asarray(mu, np.float64), (n_c,))
    i64 = dict(dtype=torch.int64, device=device)
    return CellCore(
        gather_u=torch.as_tensor(gather_u, **i64),
        gather_p=torch.as_tensor(c2v, **i64),
        JxW=JxW, grads=grads,
        lam=torch.as_tensor(lam_arr.copy(), **f64),
        mu=torch.as_tensor(mu_arr.copy(), **f64),
        inv_diam2=torch.as_tensor(1.0 / mesh.diameters**2, **f64),
        shape_v=t.shape_v)


def cell_arrays_from_core(core: CellCore, dtype: torch.dtype,
                          perm: np.ndarray | None = None) -> CellArrays:
    """CellArrays (optionally cell-permuted, e.g. into lattice raster
    order with LatticeLayout.cell_perm) derived from a CellCore: permute
    the cell-first arrays, cast the floating ones, move cells last."""
    device = core.JxW.device
    idx = (None if perm is None
           else torch.as_tensor(np.asarray(perm, np.int64), device=device))

    def last(a):
        if idx is not None:
            a = a[idx]
        if a.is_floating_point():
            a = a.to(dtype)
        return a.movedim(0, -1).contiguous()

    return CellArrays(
        gather_u=last(core.gather_u), gather_p=last(core.gather_p),
        JxW=last(core.JxW), grads=last(core.grads),
        shape_v=torch.as_tensor(core.shape_v, dtype=dtype, device=device),
        lam=last(core.lam), mu=last(core.mu),
        inv_diam2=last(core.inv_diam2))


def _cell_values(u, phi, phi_old, phi_oold, ca: CellArrays, dim: int):
    """Gather the per-cell dof values: (u_e (nvc, dim, c), phi_e,
    pf_old_e, pf_oold_e (nvc, c))."""
    nvc = ca.gather_p.shape[0]
    u_e = u[ca.gather_u].reshape(nvc, dim, -1)
    return (u_e, phi[ca.gather_p], phi_old[ca.gather_p],
            phi_oold[ca.gather_p])


def assemble_residual(u, phi, phi_old, phi_oold, ca: CellArrays,
                      sc: Scalars, cs: CellScatter, *, dim: int,
                      with_split: bool, monolithic: bool):
    """Global Newton right-hand side (the *negative* residual, the
    reference's local_rhs sign convention, cracks.cc:2404/2423).
    Returns (ru (n_v*dim,), rp (n_v,)), raw scatter-add through `cs`
    (the scatter tables of `ca`), no constraints."""
    nvc = ca.gather_p.shape[0]
    u_e, phi_e, pfo_e, pfoo_e = _cell_values(u, phi, phi_old, phi_oold,
                                             ca, dim)
    ru_e, rp_e = _element_residual_cl(u_e, phi_e, pfo_e, pfoo_e, ca, sc,
                                      dim=dim, with_split=with_split,
                                      monolithic=monolithic)
    ru = scatter_add(cs.u, ru_e.reshape(nvc * dim, -1), torch.zeros_like(u))
    rp = scatter_add(cs.p, rp_e, torch.zeros_like(phi))
    return ru, rp


def element_matrices(u, phi, phi_old, phi_oold, ca: CellArrays,
                     sc: Scalars, *, dim: int, with_split: bool,
                     monolithic: bool):
    """Dense element Jacobians J_loc = -d(rhs_loc)/d(x_loc) per cell,
    cell-last: (ndl, ndl, n_c).  Local dof order: u dofs vertex-major
    (a*dim+d), then the nvc phi dofs.

    Built from ndl one-hot jvps of the batched cell-last residual on
    pre-gathered cell values (JAX: element_matrices(cell_last=True) via
    element_matrices_from_cellvals)."""
    return element_matrices_from_cellvals(
        *_cell_values(u, phi, phi_old, phi_oold, ca, dim), ca, sc, dim=dim,
        with_split=with_split, monolithic=monolithic)


def element_matrices_from_cellvals(u_e, phi_e, pf_old_e, pf_oold_e,
                                   ca: CellArrays, sc: Scalars, *, dim: int,
                                   with_split: bool, monolithic: bool):
    """(ndl, ndl, n_c) element Jacobians from pre-gathered per-cell
    values (u_e (nvc, dim, n_c), the phase fields (nvc, n_c)): shared by
    the flat gather path above and the lattice window path
    (solvers/lattice.element_matrices_lattice)."""
    nvc = phi_e.shape[0]
    ndl = nvc * (dim + 1)
    n_c = phi_e.shape[-1]

    def f(ue, pe):
        ru_e, rp_e = _element_residual_cl(
            ue, pe, pf_old_e, pf_oold_e, ca, sc, dim=dim,
            with_split=with_split, monolithic=monolithic)
        return torch.cat([ru_e.reshape(nvc * dim, n_c), rp_e], dim=0)

    zu = torch.zeros_like(u_e)
    zp = torch.zeros_like(phi_e)
    cols = []
    for j in range(ndl):
        du_t, dp_t = zu, zp
        if j < nvc * dim:
            a, d = divmod(j, dim)
            du_t = zu.clone()
            du_t[a, d] = 1.0
        else:
            dp_t = zp.clone()
            dp_t[j - nvc * dim] = 1.0
        _, dcol = torch.func.jvp(f, (u_e, phi_e), (du_t, dp_t))
        cols.append(-dcol)                        # J = -d(rhs)
    return torch.stack(cols, dim=1)
