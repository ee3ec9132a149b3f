"""Quantities of interest (torch device reductions + host numpy).

Port of ``cracks_tpu/qoi.py`` for the Sneddon case: bulk/crack energy
and total crack volume as one device reduction over the resident cell
arrays, the stationarity distance, and copies of the host-numpy
functionals (the closed-form TCV and phase field, the phi L2 error and
the crack-opening sweeps `compute_cod`, `compute_cod_array`,
`compute_cod_sweep`), copied because ``cracks_tpu/qoi.py`` imports jax.
The boundary load and point stress of the other test cases are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fem
from .fem import face_tables, q1_shape_grads, q1_shape_values
from .mesh import MeshData
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


def _face_geometry(mesh: MeshData, cells, faces):
    """Face-quadrature geometry for (cell, local face) pairs.

    Returns (shape_v (n,q,a), grad_real (n,q,a,dim), normals (n,q,dim),
    JxW_face (n,q), qx (n,q,dim))."""
    ft = face_tables(mesh.dim)
    X = mesh.cell_coords[cells]                       # (n, nvc, dim)
    sv = ft.shape_v[faces]                            # (n, q, a)
    sg = ft.shape_g[faces]                            # (n, q, a, dim)
    J = np.einsum("nad,nqae->nqde", X, sg)            # (n,q,dim,dim)
    invJ = np.linalg.inv(J)
    grad_real = np.einsum("nqae,nqed->nqad", sg, invJ)
    qx = np.einsum("nqa,nad->nqd", sv, X)

    dim = mesh.dim
    tan_dims = ft.tangent_dims[faces]                 # (n, dim-1)
    if dim == 2:
        tang = J[np.arange(len(cells))[:, None, None],
                 np.arange(ft.n_q)[None, :, None],
                 np.arange(dim)[None, None, :],
                 tan_dims[:, None, None, 0]]
        surf = np.linalg.norm(tang, axis=-1)          # (n, q)
    else:
        t1 = J[np.arange(len(cells))[:, None, None],
               np.arange(ft.n_q)[None, :, None],
               np.arange(dim)[None, None, :],
               tan_dims[:, None, None, 0]]
        t2 = J[np.arange(len(cells))[:, None, None],
               np.arange(ft.n_q)[None, :, None],
               np.arange(dim)[None, None, :],
               tan_dims[:, None, None, 1]]
        surf = np.linalg.norm(np.cross(t1, t2), axis=-1)
    JxW_f = surf * ft.q_weights[None, :]

    # outward normal: sign * J^{-T} e_d normalized
    nd = ft.normal_dim[faces]
    ns = ft.normal_sign[faces]
    normal = invJ[np.arange(len(cells))[:, None, None],
                  np.arange(ft.n_q)[None, :, None],
                  nd[:, None, None],
                  np.arange(dim)[None, None, :]]
    normal = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal * ns[:, None, None]
    return sv, grad_real, normal, JxW_f, qx


def compute_cod(mesh: MeshData, u, phi, eval_line: float):
    """Crack opening displacement: line integral (1/2) int u . grad(pf)
    over the cell faces perpendicular to x at x = eval_line, halved for
    double-counting (cracks.cc:3451-3549).  Returns -1e300 when no face
    matches (the reference's sentinel)."""
    dim = mesh.dim
    eps = 1e-8
    centers = mesh.cell_coords.mean(axis=1)
    near = ~((centers[:, 0] - mesh.diameters > eval_line)
             | (centers[:, 0] + mesh.diameters < eval_line))
    cand = np.where(near)[0]
    if len(cand) == 0:
        return -1e300
    # faces 0 and 1 are the x-normal faces of each cell
    cells = np.repeat(cand, 2)
    faces = np.tile(np.array([0, 1], dtype=np.int32), len(cand))
    sv, grad_real, normal, JxW_f, qx = _face_geometry(mesh, cells, faces)
    on_line = np.abs(qx[:, 0, 0] - eval_line) < eps
    if not on_line.any():
        return -1e300
    cells, faces = cells[on_line], faces[on_line]
    sv, grad_real, JxW_f = sv[on_line], grad_real[on_line], JxW_f[on_line]
    u_e = u[mesh.cell2vert[cells]]
    phi_e = phi[mesh.cell2vert[cells]]
    u_q = np.einsum("nqa,nad->nqd", sv, u_e)
    grad_pf = np.einsum("na,nqad->nqd", phi_e, grad_real)
    cod = 0.5 * np.einsum("nqd,nqd->", u_q * JxW_f[..., None], grad_pf)
    return float(cod / 2.0)


def compute_cod_array(mesh: MeshData, u, phi, n_buckets: int = 75,
                      n_iter: int = 100):
    """Bucketed COD profile over x in [-1.5, 1.5] using an iterated
    midpoint rule (cracks.cc:3323-3449).  Returns (x, values, exact).

    Matches the reference's QIterated(QMidpoint, 100) resolution in 2d
    (n_iter midpoints per axis), processing cells in chunks to bound
    memory; 3d keeps a reduced rule (the reference only evaluates this
    for the 2d Sneddon benchmark)."""
    x1, x2 = -1.5, 1.5
    n1 = n_iter if mesh.dim == 2 else min(n_iter, 20)
    axis = (np.arange(n1) + 0.5) / n1
    grids = np.meshgrid(*([axis] * mesh.dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wq = np.full(len(pts), 1.0 / len(pts))
    sv = q1_shape_values(pts, mesh.dim)
    sg = q1_shape_grads(pts, mesh.dim)
    values = np.zeros(n_buckets)
    width = (x2 - x1) / n_buckets
    # only cells overlapping the sweep window contribute
    lo = mesh.cell_coords[..., 0].min(axis=1)
    hi = mesh.cell_coords[..., 0].max(axis=1)
    cand = np.where((hi >= x1 - width) & (lo <= x2 + width))[0]
    chunk = max(1, 2 ** 22 // max(len(pts), 1))
    for s in range(0, len(cand), chunk):
        sel = cand[s:s + chunk]
        X = mesh.cell_coords[sel]
        J = np.einsum("cad,qae->cqde", X, sg)
        detJ = np.linalg.det(J)
        invJ = np.linalg.inv(J)
        grads = np.einsum("qae,cqed->cqad", sg, invJ)
        JxW = detJ * wq[None, :]
        qx = np.einsum("qa,cad->cqd", sv, X)
        u_q = np.einsum("qa,cad->cqd", sv, u[mesh.cell2vert[sel]])
        grad_pf = np.einsum("ca,cqad->cqd", phi[mesh.cell2vert[sel]], grads)
        cod_q = np.einsum("cqd,cqd->cq", u_q, grad_pf) * JxW
        idx = np.floor((qx[..., 0] - x1) / (x2 - x1) * n_buckets
                       + 0.5).astype(int)
        valid = (idx >= 0) & (idx < n_buckets)
        np.add.at(values, idx[valid], cod_q[valid])
    values = values / width / 2.0
    xs = x1 + np.arange(n_buckets) * width
    exact = 1.92e-3 * np.sqrt(np.maximum(0.0, 1.0 - xs**2))
    return xs, values, exact


def compute_cod_sweep(mesh: MeshData, u, phi, lines: np.ndarray,
                      eps: float = 1e-8):
    """COD at MANY x-lines in one batched pass (the full 769-line
    cod-NNb.txt sweep, cracks.cc:3704-3725).

    One face-geometry pass over all x-normal faces computes each face's
    COD contribution; per line the answer is a bincount over faces
    whose constant x-coordinate matches.  Returns an array of COD
    values with the reference's -1e300 sentinel where no face lies on
    the line."""
    lines = np.asarray(lines, dtype=np.float64)
    n_c = mesh.n_cells
    cells = np.repeat(np.arange(n_c), 2)
    faces = np.tile(np.array([0, 1], dtype=np.int32), n_c)
    sv, grad_real, _, JxW_f, qx = _face_geometry(mesh, cells, faces)
    fx = qx[:, 0, 0]                                  # faces are x-const
    u_e = u[mesh.cell2vert[cells]]
    phi_e = phi[mesh.cell2vert[cells]]
    u_q = np.einsum("nqa,nad->nqd", sv, u_e)
    grad_pf = np.einsum("na,nqad->nqd", phi_e, grad_real)
    contrib = 0.5 * np.einsum("nqd,nqd->n", u_q * JxW_f[..., None],
                              grad_pf)
    # match faces to lines: both sorted, pair within eps
    order = np.argsort(fx)
    fxs = fx[order]
    cs = contrib[order]
    left = np.searchsorted(fxs, lines - eps, side="left")
    right = np.searchsorted(fxs, lines + eps, side="right")
    csum = np.concatenate([[0.0], np.cumsum(cs)])
    vals = (csum[right] - csum[left]) / 2.0
    return np.where(right > left, vals, -1e300)


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
