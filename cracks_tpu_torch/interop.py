"""Carry JAX-side values over into the port's tensors.

The JAX package's mesh-epoch data (cell arrays, physics scalars,
constraints, the lattice and the Galerkin hierarchy) and Newton state
are given as any objects with the same field names (a ``cracks_tpu``
NamedTuple works); each field is read with ``np.asarray`` and becomes
a tensor on `device`.  The parity tests feed both packages identical inputs this
way.  This module imports neither jax nor ``cracks_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.constraints import Constraints, from_arrays
from .ops.physics import CellArrays, Scalars
from .ops.scatter import scatter_table
from .solvers.galerkin import GalerkinHierarchy, GLevel, level_geom
from .solvers.lattice import LatticeHierarchy, Seam


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = {np.dtype(np.bool_): torch.bool}.get(a.dtype)
        if dtype is None:
            dtype = (torch.int64 if np.issubdtype(a.dtype, np.integer)
                     else torch.float64 if a.dtype == np.float64
                     else torch.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def cell_arrays(src, *, device) -> CellArrays:
    """CellArrays from a JAX CellArrays (its `chunked` copy is
    ignored: the port sweeps all cells at once)."""
    return CellArrays(**{f: _tensor(getattr(src, f), device)
                         for f in CellArrays._fields})


def scalars(src, *, device) -> Scalars:
    return Scalars(*(_tensor(getattr(src, f), device)
                     for f in Scalars._fields))


def constraints(src, *, device) -> Constraints:
    """Constraints from a JAX Constraints (the port derives the
    masters' scatter tables itself)."""
    return from_arrays(**{f: _tensor(getattr(src, f), device)
                          for f in src._fields})


def lattice_hierarchy(src, *, device) -> LatticeHierarchy:
    """LatticeHierarchy from a JAX LatticeHierarchy, its seam (a slit
    lattice's) included."""
    seam = getattr(src, "seam", None)
    return LatticeHierarchy(
        grid=tuple(int(g) for g in src.grid), n_levels=int(src.n_levels),
        vert_pos=_tensor(src.vert_pos, device),
        dir_u=tuple(_tensor(m, device) for m in src.dir_u),
        dir_p=tuple(_tensor(m, device) for m in src.dir_p),
        P_embed=_tensor(src.P_embed, device, torch.float32),
        seam=None if seam is None else Seam(int(seam.s), int(seam.slit_lo)))


def galerkin_hierarchy(src, *, device) -> GalerkinHierarchy:
    """GalerkinHierarchy from a JAX GalerkinHierarchy: each level's
    gathers transposed to cell-first, its Constraints carried over, the
    scatter tables derived (the JAX ``fine_idx``, every finer cell in
    order, is checked and dropped)."""
    levels = []
    for lv in src.levels:
        fine_idx = np.asarray(lv.fine_idx)
        if not (fine_idx == np.arange(len(fine_idx))).all():
            raise ValueError("fine_idx is not every finer cell in order")
        t = lambda a: _tensor(a, device)
        up_p, up_u = t(lv.up_masters_p), t(lv.up_masters_u)
        w_p, w_u = t(lv.up_weights_p), t(lv.up_weights_u)
        parent = t(lv.parent_idx)
        levels.append(GLevel(
            geom=level_geom(t(np.asarray(lv.gather_u).T),
                            t(np.asarray(lv.gather_p).T),
                            constraints(lv.con, device=device)),
            inject_p=t(lv.inject_p), parent_idx=parent,
            pos_code=t(lv.pos_code), parent_scatter=scatter_table(parent),
            up_masters_p=up_p, up_weights_p=w_p,
            up_masters_u=up_u, up_weights_u=w_u,
            up_scatter_p=scatter_table(up_p, keep=w_p != 0),
            up_scatter_u=scatter_table(up_u, keep=w_u != 0)))
    return GalerkinHierarchy(levels=tuple(levels),
                             P_embed=_tensor(src.P_embed, device),
                             dim=int(src.dim))


def lattice_arrays(*arrays, device):
    """Lattice-layout values as tensors of their own dtype (f32, f64,
    bool): state vectors (k, gyp, ...) with or without the sharded
    layout's pad rows, masks, element-matrix blocks."""
    return tuple(_tensor(a, device) for a in arrays)


def solution_state(u, phi, phi_old, phi_oold, active, *, device):
    """The Newton state (u, phi, phi_old, phi_oold, active) as f64/bool
    tensors."""
    f = lambda a: _tensor(a, device, torch.float64)
    return f(u), f(phi), f(phi_old), f(phi_oold), _tensor(active, device,
                                                          torch.bool)
