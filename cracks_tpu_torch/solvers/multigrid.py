"""Multigrid (torch): the geometric GMG of the matrix-free CG, and the
pieces it shares with the lattice and the Galerkin GMG.

Port of ``cracks_tpu/solvers/multigrid.py``: the spectral-window policy
(``sharp_spectrum``, ``smoothing_range``), the V-cycle helpers
(``_prolong``, ``_restrict``, ``_chebyshev``, ``lanczos_lambda_max``,
``_power_lambda_max``) and the geometric hierarchy of the matrix-free
operator (``assembled_matvec = False`` under ``preconditioner = gmg``):
``build_hierarchy`` over the forest's truncations and ``make_vcycle``.
Production sizes of the lattice and the Galerkin GMG get the sharp
window (Lanczos lambda_max, Chebyshev smoothing range 4); golden sizes
keep the Gershgorin bound with range 20, which tracks the reference's
PDAS basin digit for digit (see the JAX module for the measured
ladder).  The geometric GMG estimates lambda_max by power iteration
and smooths with range 20 at every size, as in JAX.

The geometric levels rediscretize the operator: each level's Jacobian
action is the jvp of that level's own residual at the fine state
restricted by full weighting.  On the degraded fracture operator the
crack strip is sub-cell on every coarse level, so the coarse correction
helps little there (the JAX module's measurements: 5x Jacobi's
iterations on a Sneddon step with a developed crack); on undegraded
elasticity the V-cycle converges mesh-independently.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..mesh import interpolation_stencil
from ..ops import physics
from ..ops.constraints import Constraints, make_constraints
from ..ops.scatter import (CellScatter, ScatterTable, cell_scatter,
                           piece_size, scatter_add, scatter_table)
from ..parallel.sharding import CellRange
from .replay import replayer

SHARP_SPECTRUM_MIN_DOFS = 50_000
SHARP_RANGE = 4.0
GERSHGORIN_RANGE = 20.0
# the geometric V-cycle's Chebyshev degrees (make_vcycle's defaults in
# JAX)
VCYCLE_DEGREE = 3
COARSE_DEGREE = 12


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
    estimate).  The iteration updates v in place; on a CUDA tensor the
    iterations from the second on replay a CUDA graph of the first."""
    v = Dinv * seed
    v = v / (torch.linalg.vector_norm(v) + 1e-300)

    def step():
        w = Dinv * op(v)
        v.copy_(w / (torch.linalg.vector_norm(w) + 1e-300))

    run = replayer(step, v.is_cuda)
    for _ in range(iters):
        run()
    w = Dinv * op(v)
    lam = torch.dot(v, w) / (torch.dot(v, v) + 1e-300)
    return lam.clamp_min(1e-30)


# ---------------------------------------------------------------------------
# the geometric hierarchy (host side, per mesh epoch)
# ---------------------------------------------------------------------------

class Level(NamedTuple):
    """One geometric level below the finest (coarsest first).  The
    transfer arrays prolong from the next-coarser level into this one
    (None on the coarsest); their scatter tables are the restriction's
    sum order."""

    ca: physics.CellArrays
    con: Constraints
    cs: CellScatter
    inject_p: torch.Tensor          # (n_v_l,) level vertex -> fine vertex
    inject_u: torch.Tensor          # (n_v_l*dim,) flat u-dof injection
    masters_p: torch.Tensor | None  # (n_v_l, 2^dim) coarse vertex ids
    weights_p: torch.Tensor | None  # (n_v_l, 2^dim)
    masters_u: torch.Tensor | None  # (n_v_l*dim, 2^dim) flat u dofs
    weights_u: torch.Tensor | None
    scatter_p: ScatterTable | None
    scatter_u: ScatterTable | None


class Hierarchy(NamedTuple):
    levels: tuple                   # coarsest ... finest-1
    # the finest level's prolongation from levels[-1]:
    masters_p: torch.Tensor
    weights_p: torch.Tensor
    masters_u: torch.Tensor
    weights_u: torch.Tensor
    scatter_p: ScatterTable
    scatter_u: ScatterTable


def _expand_u(masters, weights, dim):
    comp = np.arange(dim)
    m_u = (masters.astype(np.int64)[:, None, :] * dim
           + comp[None, :, None]).reshape(-1, masters.shape[1])
    w_u = np.repeat(weights, dim, axis=0)
    return m_u, w_u


def _transfer(masters, weights, dim, *, device, dtype):
    """(masters_p, weights_p, masters_u, weights_u, scatter_p,
    scatter_u) on `device` from a host interpolation stencil."""
    m_u, w_u = _expand_u(masters, weights, dim)
    i64 = dict(dtype=torch.int64, device=device)
    mp = torch.as_tensor(masters.astype(np.int64), **i64)
    mu = torch.as_tensor(m_u, **i64)
    wp = torch.as_tensor(weights, dtype=dtype, device=device)
    wu = torch.as_tensor(w_u, dtype=dtype, device=device)
    return (mp, wp, mu, wu, scatter_table(mp, keep=wp != 0),
            scatter_table(mu, keep=wu != 0))


def build_hierarchy(forest, fine_mesh, lam_fn, dirichlet_fn, *, device,
                    dtype: torch.dtype = torch.float64):
    """The geometric GMG hierarchy of the current forest: its
    truncations to levels 0..lmax-1 (the finest level is the System's),
    a truncation with as many vertices as the one before it skipped.
    lam_fn(mesh) -> (lam_cells, mu_cells); dirichlet_fn(mesh) ->
    (mask_u (n_v, dim), mask_p (n_v,)).  Returns None when the chain is
    empty (a forest of one level).  A level vertex missing from the
    fine mesh raises."""
    dim = fine_mesh.dim
    lmax = int(forest.level.max())
    fine_keys = fine_mesh.vertex_keys
    levels = []
    prev = None  # (forest, mesh) of the level below
    for lv in range(lmax):
        f_l = forest.truncated(lv)
        if f_l.n_cells == forest.n_cells:
            break  # truncation is a no-op from here on
        m_l = f_l.extract()
        if prev is not None and m_l.n_vertices == prev[1].n_vertices:
            continue
        lam, mu = lam_fn(m_l)
        ca = physics.cell_arrays_from_core(
            physics.build_cell_core(m_l, lam, mu, device=device), dtype)
        mask_u, mask_p = dirichlet_fn(m_l)
        con = make_constraints(m_l, mask_u, mask_p, dtype=dtype,
                               device=device)
        pos = np.searchsorted(fine_keys, m_l.vertex_keys)
        if not (fine_keys[np.minimum(pos, len(fine_keys) - 1)]
                == m_l.vertex_keys).all():
            raise RuntimeError("a geometric level vertex is missing from "
                               "the fine mesh")
        inject_p = pos.astype(np.int64)
        inject_u = (inject_p[:, None] * dim
                    + np.arange(dim)[None, :]).reshape(-1)
        up = ((None,) * 6 if prev is None else _transfer(
            *interpolation_stencil(prev[0], prev[1], m_l), dim,
            device=device, dtype=dtype))
        levels.append(Level(
            ca, con, cell_scatter(ca, m_l.n_vertices * dim, m_l.n_vertices),
            torch.as_tensor(inject_p, device=device),
            torch.as_tensor(inject_u, device=device), *up))
        prev = (f_l, m_l)
    if not levels:
        return None
    return Hierarchy(tuple(levels), *_transfer(
        *interpolation_stencil(prev[0], prev[1], fine_mesh), dim,
        device=device, dtype=dtype))


def on_shards(hier: Hierarchy, n_shards: int, mesh=None) -> Hierarchy:
    """The hierarchy of the replicated cell-axis mode with n_shards > 1
    shards: every level's per-cell functions in the card's pieces of its
    cells (`scatter.piece_size`), and on W ranks (`mesh`, the ranks'
    ShardMesh) every level's cells split as the finest level's are
    (`sharding.CellRange`), this process keeping the cell arrays of its
    range of each level; the level operators gather every rank's
    per-cell terms (`CellScatter.cell_terms`)."""
    levels = []
    for lv in hier.levels:
        n = lv.ca.JxW.shape[-1]
        cs = lv.cs._replace(cells=None if mesh is None else CellRange(n, mesh),
                            piece=piece_size(n, n_shards))
        levels.append(lv._replace(ca=cs.own(lv.ca), cs=cs))
    return hier._replace(levels=tuple(levels))


# ---------------------------------------------------------------------------
# the geometric V-cycle
# ---------------------------------------------------------------------------

class GMGBlock(NamedTuple):
    """One diagonal block's (u or phi) V-cycle data, coarsest level
    first, built per solve."""

    ops: tuple          # masked level operators
    Dinvs: tuple        # Jacobi inverses
    lam_maxes: tuple    # power-iteration lambda_max(D^-1 A)
    masters: tuple      # prolongation stencils (None on the coarsest)
    weights: tuple
    scatters: tuple     # their restriction scatter tables
    n_dofs: tuple
    zmasks: tuple       # constrained dofs (True = zero)


def make_vcycle(block: GMGBlock, degree: int = VCYCLE_DEGREE,
                coarse_degree: int = COARSE_DEGREE,
                rng: float = GERSHGORIN_RANGE):
    """The V-cycle M^-1 r: Chebyshev pre- and post-smoothing of
    `degree` on every level, Chebyshev of `coarse_degree` on the
    coarsest, each level kept on its free subspace (restricted
    residuals and prolonged corrections re-masked)."""
    top = len(block.ops) - 1

    def cycle(level, b):
        zm = block.zmasks[level]
        b = torch.where(zm, 0.0, b)
        op = block.ops[level]
        Dinv = block.Dinvs[level]
        lam = block.lam_maxes[level]
        if level == 0:
            return _chebyshev(op, Dinv, b, lam, coarse_degree, rng)
        x = _chebyshev(op, Dinv, b, lam, degree, rng)
        r = b - op(x)
        r_c = _restrict(r, block.masters[level], block.weights[level],
                        block.scatters[level], block.n_dofs[level - 1])
        e_c = cycle(level - 1, r_c)
        x = x + torch.where(zm, 0.0, _prolong(e_c, block.masters[level],
                                              block.weights[level]))
        r = b - op(x)
        return x + _chebyshev(op, Dinv, r, lam, degree, rng)

    return lambda b: cycle(top, b)
