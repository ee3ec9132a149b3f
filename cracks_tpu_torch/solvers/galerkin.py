"""Galerkin element-embedding matrices (host numpy).

Only `embedding_matrices` of ``cracks_tpu/solvers/galerkin.py`` is
ported: the lattice coarsening (solvers/lattice.coarsen) needs it.  The
Galerkin GMG itself is ROADMAP A10.
"""

from __future__ import annotations

import numpy as np


def embedding_matrices(dim: int) -> np.ndarray:
    """(2^dim + 1, ndl, ndl) local embedding P_pos with
    P[a_fine_local_dof, b_coarse_local_dof]; the last entry is the
    identity (pass-through cells)."""
    nvc = 2 ** dim
    ndl = nvc * (dim + 1)
    out = np.zeros((nvc + 1, ndl, ndl))
    for pos in range(nvc):
        Ps = np.zeros((nvc, nvc))
        for a in range(nvc):
            row = np.ones(nvc)
            for d in range(dim):
                x = (((pos >> d) & 1) + ((a >> d) & 1)) / 2.0
                for b in range(nvc):
                    row[b] *= x if ((b >> d) & 1) else (1.0 - x)
            Ps[a] = row
        P = np.zeros((ndl, ndl))
        for a in range(nvc):
            for b in range(nvc):
                for d in range(dim):
                    P[a * dim + d, b * dim + d] = Ps[a, b]
                P[nvc * dim + a, nvc * dim + b] = Ps[a, b]
        out[pos] = P
    out[nvc] = np.eye(ndl)
    return out
