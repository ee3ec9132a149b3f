"""The operator caches of the split solves, keyed at their build point.

The element Jacobians depend only on (u, phi, phi_old, phi_oold) and
the physics scalars.  Newton iterations at the residual floor move
those by ~1e-10 relative, so the lattice and the Galerkin split solves
reuse an operator while the context has moved by at most `jac_rtol`
from the point where it was BUILT (an inexact Newton step with an
O(jac_rtol) perturbation of the preconditioner; the residuals and the
line search stay exact).  Keying at the build point, never at the
latest iterate, keeps a slow drift from going unnoticed (ROADMAP C2,
a fault of the JAX package's fused Galerkin cache).
"""

from __future__ import annotations

import torch


def scalars_vec(sc) -> torch.Tensor:
    return torch.stack([v.to(torch.float64) for v in sc])


def iter_dist(u, phi, phi_old, phi_oold, sc_vec, u0, phi0, phi_old0,
              phi_oold0, sc_vec0, amax=None) -> float:
    """Max-relative distance between everything the element Jacobians
    depend on: u scaled by its own magnitude, phi and the previous-step
    phase fields by their O(1) scale, the time-dependent scalars
    relatively.  `amax`, when the fields are a process's part of them,
    takes the elementwise maximum of a vector over all processes, so
    that every process decides alike."""
    top = torch.stack([u0.abs().max(), (u - u0).abs().max(),
                       (phi - phi0).abs().max(),
                       (phi_old - phi_old0).abs().max(),
                       (phi_oold - phi_oold0).abs().max()])
    if amax is not None:
        top = amax(top)
    d = top[1] / top[0].clamp_min(1e-30)
    d = torch.maximum(d, top[2:].max())
    rel = (sc_vec - sc_vec0).abs() / sc_vec0.abs().clamp_min(1e-30)
    dsc = torch.where(sc_vec == sc_vec0, 0.0, rel).max()
    return float(torch.maximum(d, dsc))


def lookup(cache, ctx, flags, jac_rtol: float, amax=None):
    """The payload of `cache` = (ctx0, flags0, payload) when it was
    built with the same flags at a context within `jac_rtol` of `ctx`
    (same shapes), else None (`amax`: see `iter_dist`)."""
    if cache is None:
        return None
    ctx0, flags0, payload = cache
    if flags0 != flags or any(a.shape != b.shape for a, b in zip(ctx0, ctx)):
        return None
    return payload if iter_dist(*ctx, *ctx0, amax) <= jac_rtol else None
