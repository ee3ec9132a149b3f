"""Quantities of interest (torch device reductions + host numpy).

Port of the per-step tier of ``cracks_tpu/qoi.py``: bulk/crack energy
and total crack volume as one device reduction over the resident cell
arrays, the stationarity distance, and the host-numpy Sneddon
references (closed-form TCV and phase field, phi L2 error), copied
because ``cracks_tpu/qoi.py`` imports jax.  The crack-opening sweeps
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fem
from .ops.physics import CellArrays


def energy_tcv_device(u, phi, ca: CellArrays, lam_e, mu_e, constant_k,
                      alpha_eps, G_c, *, dim: int):
    """(bulk energy, crack energy, TCV) as 0-d f64 device tensors
    (cracks.cc:3615-3701, 3553-3589).

    bulk  = ((1+k) pf^2 + k) psi(e)      [note (1+k), reference quirk]
    crack = G_c/2 ((pf-1)^2/eps + eps |grad pf|^2)
    tcv   = u . grad(pf)

    `ca` is the System's f64 CellArrays in assembly order; `lam_e`/
    `mu_e` the energy Lame fields as (n_c,) device tensors."""
    nvc = ca.gather_p.shape[0]
    u_e = u[ca.gather_u].reshape(nvc, dim, -1)
    phi_e = phi[ca.gather_p]
    grad_u = torch.einsum("adc,qaec->qdec", u_e, ca.grads)
    pf = torch.einsum("qa,ac->qc", ca.shape_v, phi_e)
    grad_pf = torch.einsum("ac,qaec->qec", phi_e, ca.grads)
    u_q = torch.einsum("qa,adc->qdc", ca.shape_v, u_e)
    trE = sum(grad_u[:, d, d] for d in range(dim))
    E2 = 0.0
    for d in range(dim):
        for e in range(dim):
            Ede = 0.5 * (grad_u[:, d, e] + grad_u[:, e, d])
            E2 = E2 + Ede * Ede
    psi = 0.5 * lam_e[None, :] * trE**2 + mu_e[None, :] * E2
    bulk = torch.sum(((1.0 + constant_k) * pf**2 + constant_k) * psi
                     * ca.JxW)
    crack = torch.sum(0.5 * G_c * ((pf - 1.0) ** 2 / alpha_eps
                                   + alpha_eps * torch.sum(grad_pf**2, dim=1))
                      * ca.JxW)
    tcv = torch.sum(torch.einsum("qdc,qdc->qc", u_q, grad_pf) * ca.JxW)
    return bulk, crack, tcv


def linf_diff_device(u, u_old, phi, phi_old):
    """max(|u - u_old|_inf, |phi - phi_old|_inf): the Sneddon
    stationarity criterion (cracks.cc:4483-4489)."""
    return torch.maximum((u - u_old).abs().max(), (phi - phi_old).abs().max())


def tcv_exact(dim: int, pressure: float, poisson_nu: float) -> float:
    """Sneddon closed-form reference volume (cracks.cc:3591-3602)."""
    l0, E = 1.0, 1.0
    if dim == 2:
        return 2.0 * pressure * l0**2 * (1 - poisson_nu**2) * np.pi / E
    return 16.0 * pressure * l0**3 * (1 - poisson_nu**2) / E / 3.0


def sneddon_exact_phi(points: np.ndarray, alpha_eps: float) -> np.ndarray:
    """Sneddon closed-form phase field 1 - exp(-dist/eps) at arbitrary
    points, dist = distance to the slit [-1,1] x {0} (cracks.cc:417-455)."""
    points = np.asarray(points)
    xx = points[..., 0]
    dist_interior = (np.abs(points[..., 1]) if points.shape[-1] == 2
                     else np.sqrt(points[..., 1] ** 2 + points[..., 2] ** 2))
    left = points.copy()
    left[..., 0] = -1.0
    left[..., 1:] = 0.0
    right = left.copy()
    right[..., 0] = 1.0
    d_left = np.linalg.norm(points - left, axis=-1)
    d_right = np.linalg.norm(points - right, axis=-1)
    dist = np.where(xx < -1.0, d_left,
                    np.where(xx > 1.0, d_right, dist_interior))
    return 1.0 - np.exp(-dist / alpha_eps)


def sneddon_phi_l2_error(mesh, phi, alpha_eps: float):
    """|| phi - phi_exact ||_L2 with the Sneddon closed-form phase field
    (cracks.cc:417-455, 4495-4524); `phi` is a host numpy array."""
    t = fem.element_tables(mesh.dim)
    JxW, _ = fem.cell_geometry(mesh.cell_coords, t)
    qx = np.einsum("qa,cad->cqd", t.shape_v, mesh.cell_coords)
    pf = np.einsum("qa,ca->cq", t.shape_v, phi[mesh.cell2vert])
    exact = sneddon_exact_phi(qx, alpha_eps)
    return float(np.sqrt(np.sum((pf - exact) ** 2 * JxW)))
