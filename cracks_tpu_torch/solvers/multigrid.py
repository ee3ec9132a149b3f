"""Multigrid pieces shared by the lattice and the Galerkin GMG (torch).

Port of the spectral-window policy (``sharp_spectrum``,
``smoothing_range``) and the V-cycle helpers (``_prolong``,
``_restrict``, ``_chebyshev``, ``lanczos_lambda_max``,
``_power_lambda_max``) of ``cracks_tpu/solvers/multigrid.py``.
Production sizes get the sharp window (Lanczos lambda_max, Chebyshev
smoothing range 4); golden sizes keep the Gershgorin bound with range
20, which tracks the reference's PDAS basin digit for digit (see the
JAX module for the measured ladder).  The geometric hierarchy
(``build_hierarchy``, ``make_vcycle``) serves only the matrix-free CG
and is ROADMAP A12.
"""

from __future__ import annotations

import math

import torch

from ..ops.scatter import ScatterTable, scatter_add

SHARP_SPECTRUM_MIN_DOFS = 50_000
SHARP_RANGE = 4.0
GERSHGORIN_RANGE = 20.0


def sharp_spectrum(n_dofs: int) -> bool:
    return n_dofs > SHARP_SPECTRUM_MIN_DOFS


def smoothing_range(sharp: bool) -> float:
    return SHARP_RANGE if sharp else GERSHGORIN_RANGE


def _prolong(x_c, masters, weights):
    """Q1 interpolation: fine value = weights . coarse masters."""
    return (weights * x_c[masters]).sum(dim=1)


def _restrict(r_f, masters, weights, st: ScatterTable, n_coarse: int):
    """The exact transpose of `_prolong`, summed in index order
    (`st` is the scatter table of `masters`)."""
    return scatter_add(st, weights * r_f[:, None],
                       r_f.new_zeros(n_coarse))


def _chebyshev(op, Dinv, b, lam_max, degree, rng):
    """Chebyshev smoother for D^-1 A with eigenvalues in
    [lam_max/rng, 1.2 lam_max], zero initial guess (deal.II
    PreconditionChebyshev conventions; the 1.2 safety factor matters:
    an underestimated upper bound amplifies the top modes)."""
    upper = 1.2 * lam_max
    lower = lam_max / rng
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    r = b
    p = (1.0 / theta) * (Dinv * r)
    x = p
    sigma = theta / delta
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        r = b - op(x)
        rho = 1.0 / (2.0 * sigma - rho_old)
        p = (rho * rho_old) * p + (2.0 * rho / delta) * (Dinv * r)
        x = x + p
        rho_old = rho
    return x


def lanczos_lambda_max(op, Dinv, free, m: int = 16):
    """Sharp lambda_max(D^-1 A) estimate on the free subspace: m-step
    Lanczos on S = D^(-1/2) A D^(-1/2) from a hash-sign start vector,
    top Ritz value (eigenvalues of the tridiagonal T in f32, as in JAX).
    `op` must mask its input and output to the free subspace.  Returns
    a 0-d tensor; non-finite when the free set is empty (the caller
    falls back to the Gershgorin bound)."""
    dtype = Dinv.dtype
    sq = Dinv.abs().sqrt()
    idx = torch.arange(free.shape[0], dtype=torch.int64, device=free.device)
    h = ((idx * 2654435761) & 0xFFFFFFFF) >> 16
    sign = torch.where((h & 1) == 1, -1.0, 1.0).to(dtype)
    v = torch.where(free, sign, 0.0)
    n0 = torch.sqrt(torch.dot(v, v))
    v = torch.where(n0 > 0, v / n0.clamp_min(1e-30), v)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(m):
        w = sq * op(sq * v) - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta_new = torch.sqrt(torch.dot(w, w))
        v_new = torch.where(beta_new > 0, w / beta_new.clamp_min(1e-30), w)
        alphas.append(alpha)
        betas.append(beta_new)
        v_prev, v, beta = v, v_new, beta_new
    a = torch.stack(alphas).to(torch.float32).cpu()
    b = torch.stack(betas).to(torch.float32).cpu()
    T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    if not bool(torch.isfinite(T).all()):
        return torch.tensor(math.nan, dtype=dtype, device=Dinv.device)
    return torch.linalg.eigvalsh(T).max().to(dtype).to(Dinv.device)


def _power_lambda_max(op, Dinv, seed, iters: int = 15):
    """lambda_max(D^-1 A) by power iteration (the geometric GMG's
    estimate, ROADMAP A12)."""
    v = Dinv * seed
    v = v / (torch.linalg.vector_norm(v) + 1e-300)
    for _ in range(iters):
        w = Dinv * op(v)
        v = w / (torch.linalg.vector_norm(w) + 1e-300)
    w = Dinv * op(v)
    lam = torch.dot(v, w) / (torch.dot(v, v) + 1e-300)
    return lam.clamp_min(1e-30)
