"""Kelly face-jump error estimator for the `mix` refinement strategy.

The port's copy of ``cracks_tpu/kelly.py`` (numpy only).

Exact analogue of deal.II's ``KellyErrorEstimator`` as used by the
reference (cracks.cc:4070-4083): per cell K

    eta_K^2 = sum_{F in faces(K)}  h_F / 24 *
              integral_F [ n . grad u_h ]^2 ds,

summed over the displacement components (component mask excludes the
phase field, cracks.cc:4071-4072), with QGauss(degree+2) = 3-point
Gauss face quadrature (cracks.cc:4079) and h_F the diameter of the
cell's own face.  Faces with hanging nodes are integrated from the
refined side over each subface and attributed to both neighbors — the
same subface treatment deal.II applies.

Host-side numpy: the estimator runs once per refinement decision on the
current mesh (not in the Newton hot path), exactly like the reference's
serial Kelly sweep per AMR cycle.
"""

from __future__ import annotations

import numpy as np

from .fem import face_tables, q1_shape_grads, q1_shape_values
from .mesh import MeshData
from .meshio import face_vertices


def _face_corner_ids(mesh: MeshData) -> np.ndarray:
    """(n_cells, n_faces, 2^(dim-1)) global vertex ids of each face."""
    fv = np.asarray(face_vertices(mesh.dim), dtype=np.int64)
    return mesh.cell2vert[:, fv]


def _sorted_key_rows(corners2d: np.ndarray) -> np.ndarray:
    """Rows -> void dtype keys for fast grouping (corners2d (m, k))."""
    s = np.ascontiguousarray(np.sort(corners2d.astype(np.int64), axis=1))
    return s.view([("", np.int64)] * s.shape[1]).ravel()


def _inverse_map(Xcell: np.ndarray, xphys: np.ndarray,
                 dim: int) -> np.ndarray:
    """Reference coordinates of physical points inside bilinear cells.

    Xcell (m, 2^dim, dim); xphys (m, dim).  Newton on the Q1 map —
    converges in one step for affine (axis-aligned) cells."""
    xi = np.full_like(xphys, 0.5)
    for _ in range(30):
        N = q1_shape_values(xi, dim)              # (m, 2^dim)
        G = q1_shape_grads(xi, dim)               # (m, 2^dim, dim)
        R = np.einsum("ma,mad->md", N, Xcell) - xphys
        J = np.einsum("mad,mae->mde", Xcell, G)   # J[d,e] = dx_d/dxi_e
        step = np.linalg.solve(J, R[..., None])[..., 0]
        xi = xi - step
        if np.abs(step).max() < 1e-13:
            break
    else:
        import warnings
        warnings.warn("kelly._inverse_map: Newton on the Q1 map did not "
                      f"converge (max |step| {np.abs(step).max():.2e})")
    return xi


def _grad_at(Xcell: np.ndarray, u_cell: np.ndarray,
             xi: np.ndarray, dim: int) -> np.ndarray:
    """grad u (m, comp, dim) of a Q1 vector field at reference points xi.

    Xcell (m, 2^dim, dim); u_cell (m, 2^dim, comp); xi (m, dim)."""
    G = q1_shape_grads(xi, dim)                   # (m, 2^dim, dim)
    J = np.einsum("mad,mae->mde", Xcell, G)       # dx_d/dxi_e
    invJ = np.linalg.inv(J)
    gphys = np.einsum("mae,med->mad", G, invJ)    # dN_a/dx_d
    return np.einsum("mac,mad->mcd", u_cell, gphys)


def _face_diameters(mesh: MeshData) -> np.ndarray:
    """(n_cells, n_faces) diameter (max corner distance) of each face."""
    fc = mesh.cell_coords[
        np.arange(mesh.n_cells)[:, None, None],
        np.asarray(face_vertices(mesh.dim), dtype=np.int64)[None]]
    d = fc[:, :, :, None, :] - fc[:, :, None, :, :]
    return np.sqrt((d ** 2).sum(-1)).max(axis=(2, 3))


def _match_faces(mesh: MeshData):
    """Interior face pairing.

    Returns (cells_a, faces_a, cells_b, faces_b): side `a` is the
    integration side (the finer cell for hanging faces; arbitrary for
    equal-level faces), side `b` the neighbor."""
    n_c = mesh.n_cells
    n_f = 2 * mesh.dim
    corners = _face_corner_ids(mesh)                    # (c, f, k)
    flat = corners.reshape(n_c * n_f, -1)
    keys = _sorted_key_rows(flat)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    grp_start = np.r_[0, np.nonzero(ks[1:] != ks[:-1])[0] + 1]
    grp_size = np.r_[grp_start[1:], len(ks)] - grp_start

    pair_a, pair_b = [], []
    # equal-level interior faces: the key occurs exactly twice
    two = grp_size == 2
    ia = order[grp_start[two]]
    ib = order[grp_start[two] + 1]
    pair_a.append(ia)
    pair_b.append(ib)

    # singles: boundary faces, coarse faces with refined neighbors, and
    # fine subfaces.  Promote fine subfaces (faces containing a hanging
    # vertex) to the parent-face key and match against coarse singles.
    singles = order[grp_start[grp_size == 1]]
    if len(mesh.hang_child) and len(singles):
        n_v = mesh.n_vertices
        # vertex -> masters lookup (identity for non-hanging)
        prom = np.tile(np.arange(n_v, dtype=np.int64)[:, None], (1, 4))
        prom[mesh.hang_child] = mesh.hang_masters.astype(np.int64)
        sc = flat[singles]                              # (s, k)
        has_hang = np.isin(sc, mesh.hang_child).any(axis=1)
        fine = singles[has_hang]
        coarse = singles[~has_hang]
        if len(fine) and len(coarse):
            k = flat.shape[1]
            promoted = prom[flat[fine]].reshape(len(fine), 4 * k)
            # parent-face corner set: unique per row, must have exactly
            # k entries (pad rows that don't to an unmatchable key)
            promoted = np.sort(promoted, axis=1)
            uniq_keys = np.full((len(fine), k), -1, dtype=np.int64)
            for r in range(len(fine)):
                uq = np.unique(promoted[r])
                if len(uq) == k:
                    uniq_keys[r] = uq
                else:
                    uniq_keys[r, 0] = -2 - r            # unmatchable
            fine_keys = _sorted_key_rows(uniq_keys)
            coarse_keys = _sorted_key_rows(flat[coarse])
            co = np.argsort(coarse_keys, kind="stable")
            pos = np.searchsorted(coarse_keys[co], fine_keys)
            pos_c = np.minimum(pos, len(co) - 1)
            hit = coarse_keys[co[pos_c]] == fine_keys
            pair_a.append(fine[hit])
            pair_b.append(coarse[co[pos_c[hit]]])

    ia = np.concatenate(pair_a) if pair_a else np.zeros(0, np.int64)
    ib = np.concatenate(pair_b) if pair_b else np.zeros(0, np.int64)
    return ia // n_f, ia % n_f, ib // n_f, ib % n_f


def kelly_estimate(mesh: MeshData, u: np.ndarray) -> np.ndarray:
    """Per-cell Kelly error indicator eta_K of the displacement field.

    u: flat (n_vertices*dim,) displacement vector.  Returns (n_cells,)
    eta values (deal.II convention: sqrt of the summed face terms)."""
    dim = mesh.dim
    n_c = mesh.n_cells
    n_f = 2 * dim
    uv = np.asarray(u, dtype=np.float64).reshape(-1, dim)
    ca, fa, cb, fb = _match_faces(mesh)
    face_int = np.zeros((n_c, n_f))
    if len(ca):
        ft = face_tables(dim)
        n_q = ft.n_q
        Xa = mesh.cell_coords[ca]                        # (m, 2^dim, dim)
        Xb = mesh.cell_coords[cb]
        ua = uv[mesh.cell2vert[ca]]                      # (m, 2^dim, dim)
        ub = uv[mesh.cell2vert[cb]]

        # integration-side reference points and physical positions
        xi_a = ft.q_cell_points[fa]                      # (m, n_q, dim)
        Na = q1_shape_values(xi_a.reshape(-1, dim), dim).reshape(
            len(ca), n_q, -1)
        xphys = np.einsum("mqa,mad->mqd", Na, Xa)        # (m, n_q, dim)

        # face surface measure + unit normal from side a's geometry
        Ga = q1_shape_grads(xi_a.reshape(-1, dim), dim).reshape(
            len(ca), n_q, -1, dim)
        tang = np.einsum("mqae,mad->mqed", Ga, Xa)       # dx/dxi_e
        tdims = ft.tangent_dims[fa]                      # (m, dim-1)
        m_idx = np.arange(len(ca))[:, None, None]
        q_idx = np.arange(n_q)[None, :, None]
        T = tang[m_idx, q_idx, tdims[:, None, :]]        # (m, n_q, dim-1, dim)
        if dim == 2:
            t0 = T[:, :, 0]
            dS = np.sqrt((t0 ** 2).sum(-1))
            normal = np.stack([t0[..., 1], -t0[..., 0]], axis=-1)
        else:
            cr = np.cross(T[:, :, 0], T[:, :, 1])
            dS = np.sqrt((cr ** 2).sum(-1))
            normal = cr
        normal = normal / np.maximum(dS, 1e-300)[..., None]
        JxW = dS * ft.q_weights[None, :]                 # (m, n_q)

        # gradients from both sides at the same physical points
        ga = _grad_at(
            np.repeat(Xa, n_q, axis=0),
            np.repeat(ua, n_q, axis=0),
            xi_a.reshape(-1, dim), dim).reshape(len(ca), n_q, dim, dim)
        xi_b = _inverse_map(np.repeat(Xb, n_q, axis=0),
                            xphys.reshape(-1, dim), dim)
        gb = _grad_at(
            np.repeat(Xb, n_q, axis=0),
            np.repeat(ub, n_q, axis=0),
            xi_b, dim).reshape(len(ca), n_q, dim, dim)

        jump = np.einsum("mqcd,mqd->mqc", ga - gb, normal)
        integral = np.einsum("mqc,mqc,mq->m", jump, jump, JxW)

        np.add.at(face_int, (ca, fa), integral)
        np.add.at(face_int, (cb, fb), integral)

    h_face = _face_diameters(mesh)
    eta2 = (h_face / 24.0 * face_int).sum(axis=1)
    return np.sqrt(eta2)
