"""Carry JAX-side values over into the port's tensors.

The JAX package's mesh-epoch data (cell arrays, physics scalars,
constraints, the lattice hierarchy) and Newton state are given as any
objects with the same field names (a ``cracks_tpu`` NamedTuple works);
each field is read with ``np.asarray`` and becomes a tensor on
`device`.  The parity tests feed both packages identical inputs this
way.  This module imports neither jax nor ``cracks_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.constraints import Constraints, from_arrays
from .ops.physics import CellArrays, Scalars
from .solvers.lattice import LatticeHierarchy


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
    """LatticeHierarchy from a seam-free JAX LatticeHierarchy."""
    if getattr(src, "seam", None) is not None:
        raise NotImplementedError("seam lattices: ROADMAP A9")
    return LatticeHierarchy(
        grid=tuple(int(g) for g in src.grid), n_levels=int(src.n_levels),
        vert_pos=_tensor(src.vert_pos, device),
        dir_u=tuple(_tensor(m, device) for m in src.dir_u),
        dir_p=tuple(_tensor(m, device) for m in src.dir_p),
        P_embed=_tensor(src.P_embed, device, torch.float32))


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
