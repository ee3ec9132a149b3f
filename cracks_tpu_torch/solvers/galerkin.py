"""Galerkin (element-RAP) GMG on stored element matrices (torch).

Port of ``cracks_tpu/solvers/galerkin.py``.  For nested Q1 spaces a
coarse basis function restricted to a child cell is a fixed combination
of the child's basis functions, so

    A_coarse[parent] = sum_children  P_pos^T  A_fine[child]  P_pos

with 2^dim constant embedding matrices P_pos (and the identity for a
cell that exists on both levels).  The coarse element matrices inherit
the fine coefficients exactly: the degraded crack strip survives to
every level, which a rediscretized coarse operator loses.  Every level
is then a stored-element-matrix operator (a gather, a batched dense
matvec, an ordered scatter), smoothed by Chebyshev, with a dense f64
Cholesky on the coarsest level (the reference's Amesos-direct analogue,
cracks.cc:2750-2758).

Hanging nodes: the RAP coarsens the raw (unconstrained) nodal operators,
and each level applies its own hanging-node condensation in the
operator, A_l^cond x = mask . H_l^T A_l^raw H_l . mask x (deal.II's
level matrices with level constraints).  A level mesh may carry hanging
nodes where the fine mesh does not.

Layout: level element matrices are cell-first, (n_c, ndl, ndl), so each
block product is one `torch.bmm`; gathers are (n_c, nvc*dim) and
(n_c, nvc), and every scatter sums in index order (`ops/scatter.py`),
so a card run repeats its iterates bit for bit.  On W ranks of the
replicated cell-axis mode the finest level is split: a rank builds and
stores its own cells' element matrices, and every fine product, diagonal
and row sum gathers all ranks' per-cell terms before the ordered
scatter.  The coarse chain is built on every rank from the gathered
fine matrices and runs whole there (its split is ROADMAP A11e part 2).

Two solves use the hierarchy (`solvers/newton._solve_assembled`):
`solve_cg_block`, the f64 Galerkin-preconditioned block CG with
restarted refinement passes, and `solve_split`, the mixed-precision
solve: f32 element matrices rebuilt from f32 inputs, all-f32 CG passes
preconditioned by the f32 V-cycle, and the exact f64 residual between
passes through one jvp of the f64 element residual (no f64 matrix is
built).  The JAX package's fused one-dispatch variant
(``solve_newton_system``) exists only for the TPU's dispatch latency
and is not ported; `solve_split` serves every size, with the fused
solve's residual target up to the size JAX fuses (`block_target`).  Each CG loop keeps
its exit test on the card (iterations after the exit leave the state
as it was) and reads it every `CHECK_EVERY` iterations, so the host
waits once per few iterations instead of once per iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..mesh import Forest, MeshData, interpolation_stencil
from ..ops import physics
from ..ops.constraints import (Constraints, condense_residual, expand_update,
                               hanging_interpolate_p, hanging_interpolate_u,
                               hanging_transpose_p, hanging_transpose_u,
                               make_constraints)
from ..ops.scatter import (WHOLE, CellScatter, ScatterTable, scatter_add,
                           scatter_add_rows, scatter_table)
from . import assembled, opcache
from .multigrid import (_chebyshev, _prolong, _restrict, lanczos_lambda_max,
                        sharp_spectrum, smoothing_range)

# the split solve's constants (the JAX package's defaults): the
# iterations of one f32 CG pass (a TPU-era bound, kept for parity), the
# Chebyshev degree, the staleness bound of the f32 operator cache and
# the stall window of a pass
INNER_MAX = 32
CHEB_DEGREE = 2
JAC_RTOL = 1e-6
STALL_WINDOW = 16
# CG iterations between host reads of a loop's exit flag
CHECK_EVERY = 4
# the largest system the JAX package solves in one fused dispatch
# (``cracks_tpu/solvers/lattice.py:935``, dispatched at
# ``cracks_tpu/solvers/newton.py:182``); up to it the split solve takes
# the fused solve's target, above it the split one's
FUSED_SOLVE_MAX_DOFS = 150000


# ---------------------------------------------------------------------------
# host-side hierarchy construction (per mesh epoch)
# ---------------------------------------------------------------------------

def _rows_view(*cols):
    a = np.ascontiguousarray(np.stack([c.astype(np.int64) for c in cols],
                                      axis=1))
    return a.view([("", np.int64)] * a.shape[1]).ravel()


def cell_parent_map(coarse_f: Forest, fine_f: Forest):
    """For each fine-forest cell: (parent cell index in the coarse
    forest, position code).  Position 0..2^dim-1 identifies which child
    octant; 2^dim means pass-through (the cell exists on both levels)."""
    dim = coarse_f.dim
    ckeys = _rows_view(coarse_f.root, coarse_f.level, *coarse_f.anchor.T)
    order = np.argsort(ckeys)
    csorted = ckeys[order]

    fkeys_self = _rows_view(fine_f.root, fine_f.level, *fine_f.anchor.T)
    pos_self = np.searchsorted(csorted, fkeys_self)
    pos_self_c = np.minimum(pos_self, len(csorted) - 1)
    found_self = csorted[pos_self_c] == fkeys_self

    lvl_p = np.maximum(fine_f.level - 1, 0)
    Wp = (fine_f.S >> lvl_p).astype(np.int64)
    anchor_p = (fine_f.anchor // Wp[:, None]) * Wp[:, None]
    fkeys_par = _rows_view(fine_f.root, lvl_p, *anchor_p.T)
    pos_par = np.searchsorted(csorted, fkeys_par)
    pos_par_c = np.minimum(pos_par, len(csorted) - 1)
    found_par = csorted[pos_par_c] == fkeys_par
    if not (found_self | found_par).all():
        raise RuntimeError("fine forest is not a one-level refinement of "
                           "the coarse forest")

    parent = np.where(found_self, order[pos_self_c], order[pos_par_c])
    Wf = (fine_f.S >> fine_f.level).astype(np.int64)
    child_bits = (fine_f.anchor // Wf[:, None]) & 1
    pos_code = np.zeros(len(parent), dtype=np.int64)
    for d in range(dim):
        pos_code |= child_bits[:, d] << d
    pos_code = np.where(found_self, 2 ** dim, pos_code)
    return parent.astype(np.int64), pos_code


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


class LevelGeom(NamedTuple):
    """The gather maps of one level's cells (cell-first), their scatter
    tables (the level operator's sum order) and the level's constraint
    bundle (hanging nodes and Dirichlet masks).  The finest level's
    `cs` is the System's CellScatter: its block products, diagonals and
    row sums go through `CellScatter.cell_terms`, and on W ranks of the
    replicated cell-axis mode its gathers are those of this process's
    cells, its scatter tables those of all cells."""

    gather_u: torch.Tensor     # (n_c, nvc*dim) int64
    gather_p: torch.Tensor     # (n_c, nvc) int64
    scatter_u: ScatterTable
    scatter_p: ScatterTable
    con: Constraints
    cs: CellScatter = WHOLE


def level_geom(gather_u, gather_p, con: Constraints) -> LevelGeom:
    return LevelGeom(gather_u, gather_p, scatter_table(gather_u),
                     scatter_table(gather_p), con)


def fine_geom(ca: physics.CellArrays, con: Constraints,
              cs: CellScatter = WHOLE) -> LevelGeom:
    """The finest level's LevelGeom from the System's cell arrays of
    all cells (cell-last gathers), its constraints and its CellScatter
    `cs`."""
    g = level_geom(ca.gather_u.T.contiguous(), ca.gather_p.T.contiguous(),
                   con)
    if cs.cells is not None:
        g = g._replace(gather_u=cs.cells.take(ca.gather_u).T.contiguous(),
                       gather_p=cs.cells.take(ca.gather_p).T.contiguous())
    return g._replace(cs=cs)


class GLevel(NamedTuple):
    """One level below the finest (rebuilt per mesh epoch).  The JAX
    level's ``fine_idx`` (always every finer cell in order) and its
    Dirichlet masks (those of ``con``) are not kept."""

    geom: LevelGeom
    inject_p: torch.Tensor     # (n_p,) level vertex -> fine vertex
    # coarsening from the next-finer level:
    parent_idx: torch.Tensor   # (n_cf,) this level's cell of each finer cell
    pos_code: torch.Tensor     # (n_cf,)
    parent_scatter: ScatterTable
    # prolongation stencils INTO the next-finer level, and their scatter
    # tables (the restriction's sum order)
    up_masters_p: torch.Tensor  # (n_p_finer, 2^dim)
    up_weights_p: torch.Tensor
    up_masters_u: torch.Tensor  # (n_ud_finer, 2^dim)
    up_weights_u: torch.Tensor
    up_scatter_p: ScatterTable
    up_scatter_u: ScatterTable


class GalerkinHierarchy(NamedTuple):
    levels: tuple              # coarsest ... finest-1 (GLevel)
    P_embed: torch.Tensor      # (2^dim + 1, ndl, ndl)
    dim: int


def build_galerkin_hierarchy(forest: Forest, fine_mesh: MeshData,
                             dirichlet_fn, *, device,
                             dtype: torch.dtype = torch.float64,
                             min_coarse_vertices: int = 400):
    """The Galerkin GMG hierarchy of the current forest: its truncations
    to levels 0..lmax-1, without repeats, the coarse ones below
    `min_coarse_vertices` merged into the coarsest.  Returns None when
    the chain is empty (a forest of one level).  A level vertex missing
    from the fine mesh raises (the JAX package's geometric build asserts
    on it)."""
    dim = fine_mesh.dim
    lmax = int(forest.level.max())
    chain = []  # (forest, mesh), coarse -> fine-1
    for l in range(lmax):
        f_l = forest.truncated(l)
        if f_l.n_cells == forest.n_cells:
            break
        m_l = f_l.extract()
        if chain and m_l.n_vertices == chain[-1][1].n_vertices:
            continue
        chain.append((f_l, m_l))
    while len(chain) > 1 and chain[1][1].n_vertices < min_coarse_vertices:
        chain.pop(0)
    if not chain:
        return None

    comp = np.arange(dim)
    nvc = 2 ** dim
    fine_keys = fine_mesh.vertex_keys
    i64 = dict(dtype=torch.int64, device=device)
    flt = dict(dtype=dtype, device=device)
    levels = []
    for i, (f_l, m_l) in enumerate(chain):
        finer_f = chain[i + 1][0] if i + 1 < len(chain) else forest
        finer_m = chain[i + 1][1] if i + 1 < len(chain) else fine_mesh
        parent, pos_code = cell_parent_map(f_l, finer_f)
        masters, weights = interpolation_stencil(f_l, m_l, finer_m)
        m_u = (masters.astype(np.int64)[:, None, :] * dim
               + comp[None, :, None]).reshape(-1, masters.shape[1])
        w_u = np.repeat(weights, dim, axis=0)
        mask_u, mask_p = dirichlet_fn(m_l)
        pos = np.searchsorted(fine_keys, m_l.vertex_keys)
        if not (fine_keys[np.minimum(pos, len(fine_keys) - 1)]
                == m_l.vertex_keys).all():
            raise RuntimeError("a Galerkin level vertex is missing from "
                               "the fine mesh")
        c2v = m_l.cell2vert.astype(np.int64)
        gu = (c2v[:, :, None] * dim + comp[None, None, :]).reshape(
            -1, nvc * dim)
        con = make_constraints(m_l, np.asarray(mask_u), np.asarray(mask_p),
                               dtype=dtype, device=device)
        parent_t = torch.as_tensor(parent, **i64)
        mp = torch.as_tensor(masters.astype(np.int64), **i64)
        mu = torch.as_tensor(m_u, **i64)
        weights_t = (torch.as_tensor(weights, **flt),
                     torch.as_tensor(w_u, **flt))
        levels.append(GLevel(
            geom=level_geom(torch.as_tensor(gu, **i64),
                            torch.as_tensor(c2v, **i64), con),
            inject_p=torch.as_tensor(pos.astype(np.int64), **i64),
            parent_idx=parent_t,
            pos_code=torch.as_tensor(pos_code, **i64),
            parent_scatter=scatter_table(parent_t),
            up_masters_p=mp, up_weights_p=weights_t[0],
            up_masters_u=mu, up_weights_u=weights_t[1],
            up_scatter_p=scatter_table(mp, keep=weights_t[0] != 0),
            up_scatter_u=scatter_table(mu, keep=weights_t[1] != 0)))
    return GalerkinHierarchy(
        levels=tuple(levels),
        P_embed=torch.as_tensor(embedding_matrices(dim), **flt), dim=dim)


# ---------------------------------------------------------------------------
# device-side: coarse matrices, level operators, V-cycle
# ---------------------------------------------------------------------------

def coarsen_level(jac_finer, lvl: GLevel, P_embed, n_coarse_cells: int):
    """A_l = sum P_pos^T A_{l+1} P_pos over each coarse cell's children,
    cell-first (n_cf, ndl, ndl) -> (n_coarse_cells, ndl, ndl), the
    children summed in index order."""
    P = P_embed.to(jac_finer.dtype)[lvl.pos_code]       # (n_cf, ndl, ndl)
    C = torch.bmm(P.transpose(1, 2), torch.bmm(jac_finer, P))
    del P
    ndl = jac_finer.shape[1]
    out = jac_finer.new_zeros((n_coarse_cells, ndl, ndl))
    return scatter_add_rows(lvl.parent_scatter, C, out)


def _block(jac, which: str, dim: int):
    """The u or phase-field diagonal block of cell-first element
    matrices (a view)."""
    nud_l = 2 ** dim * dim
    return jac[:, :nud_l, :nud_l] if which == "u" else jac[:, nud_l:, nud_l:]


def _matvec(blk, gather, st: ScatterTable, x, cs: CellScatter = WHOLE):
    """Raw block product: gather, batched dense matvec, ordered
    scatter-add (of every process's cells, `CellScatter.cell_terms`)."""
    (ye,) = cs.cell_terms(
        lambda b, xg: torch.bmm(b, xg.unsqueeze(-1)).squeeze(-1), blk,
        x[gather], axis=0)
    return scatter_add(st, ye, torch.zeros_like(x))


def _hang(which: str):
    """(H x, H^T r) of one block's hanging-node constraints."""
    if which == "u":
        return hanging_interpolate_u, hanging_transpose_u
    return hanging_interpolate_p, hanging_transpose_p


def _masked_op(blk, gather, st, free, con: Constraints, which: str,
               cs: CellScatter = WHOLE):
    """Condensed masked block operator: mask . H^T A_raw H . mask (H the
    identity on a conforming level)."""
    interp, transpose = _hang(which)

    def op(x):
        x = interp(torch.where(free, x, 0.0), con)
        y = transpose(_matvec(blk, gather, st, x, cs), con)
        return torch.where(free, y, 0.0)
    return op


def _gershgorin_lambda_max(blk, gather, st, free, Dinv, con: Constraints,
                           which: str, cs: CellScatter = WHOLE):
    """Deterministic upper bound on lambda_max(D^-1 A): the Gershgorin
    row sums, over-approximated element-wise.  An UPPER bound matters:
    Chebyshev amplifies modes above its window, and power iteration sits
    below lambda_max when the top mode lives in the crack strip (see the
    JAX function).  With hanging constraints, |H|^T applied to the raw
    row sums bounds the condensed rows."""
    (rs,) = cs.cell_terms(lambda b: b.abs().sum(dim=2), blk,
                          axis=0)                           # (c, b)
    s = scatter_add(st, rs, torch.zeros_like(Dinv))
    if which == "u":
        child, w, hst = con.hang_child_u, con.hang_weights_u, \
            con.hang_scatter_u
    else:
        child, w, hst = con.hang_child_p, con.hang_weights, \
            con.hang_scatter_p
    if child.numel():
        s = scatter_add(hst, w.abs().to(s.dtype) * s[child][:, None],
                        s.clone())
    return torch.where(free, s * Dinv.abs(), 0.0).max()


def _lambda_est(blk, gather, st, free, Dinv, con, which, *, sharp: bool,
                cs: CellScatter = WHOLE):
    """lambda_max(D^-1 A) for the Chebyshev smoother: the Gershgorin
    bound; with `sharp` (the production window) a 16-step Lanczos
    estimate on the symmetrized operator (J + J^T)/2, capped by the
    Gershgorin bound, which also replaces a Ritz value that is not
    finite and positive.  A block with no free dof on a level (every
    coarse phase-field vertex in the active set) has no spectrum and
    takes 1, on which the smoother returns zero; the JAX package keeps
    its bound 0 and divides by it (ROADMAP C12)."""
    lam = _gershgorin_lambda_max(blk, gather, st, free, Dinv, con, which,
                                 cs)
    if sharp:
        op = _masked_op(blk, gather, st, free, con, which, cs)
        opT = _masked_op(blk.transpose(1, 2), gather, st, free, con, which,
                         cs)
        ritz = lanczos_lambda_max(lambda x: 0.5 * (op(x) + opT(x)), Dinv,
                                  free)
        ok = torch.isfinite(ritz) & (ritz > 0)
        lam = torch.where(ok, torch.minimum(ritz, lam), lam)
    return torch.where(lam > 0, lam, 1.0)


def _level_blockdata(jacs, geoms, injects, active, which: str, *, dim: int,
                     sharp: bool):
    """(free, Dinv, lam) per level, coarsest..finest, for ONE block, with
    one diagonal per level and block (the JAX function builds both
    blocks' diagonals for each, ROADMAP C4).  The u-block data does not
    depend on the active set, so the split solve can reuse it."""
    out = []
    for i, (jac, g) in enumerate(zip(jacs, geoms)):
        con = g.con
        blk = _block(jac, which, dim)
        if which == "u":
            free = ~(con.dirichlet_u | con.hang_mask_u)
            gather, st = g.gather_u, g.scatter_u
        else:
            act_l = active if i == len(jacs) - 1 else active[injects[i]]
            free = ~(con.dirichlet_p | con.hang_mask_p | act_l)
            gather, st = g.gather_p, g.scatter_p
        (d,) = g.cs.all_cells(blk.diagonal(dim1=1, dim2=2), axis=0)
        d = scatter_add(st, d, jac.new_zeros(free.shape[0]))
        Dinv = torch.where(free & (d.abs() > 0), 1.0 / d, 1.0)
        lam = _lambda_est(blk, gather, st, free, Dinv, con, which,
                          sharp=sharp, cs=g.cs)
        out.append((free, Dinv, lam))
    return tuple(out)


class _LevelOps(NamedTuple):
    """One level's operator data for both blocks (coarsest..finest);
    up_u and up_p, the prolongation into the next-finer level with the
    weights in the operator's dtype, are None on the finest level."""

    jac: torch.Tensor          # (n_c, ndl, ndl)
    geom: LevelGeom
    free_u: torch.Tensor
    free_p: torch.Tensor
    Dinv_u: torch.Tensor
    Dinv_p: torch.Tensor
    lam_u: torch.Tensor
    lam_p: torch.Tensor
    up_u: tuple | None         # (masters, weights, scatter table)
    up_p: tuple | None
    rng: float                 # Chebyshev smoothing range


def build_level_ops(hier: GalerkinHierarchy, jac_fine, fine: LevelGeom,
                    active, *, dim: int, sharp: bool = False, reuse=None):
    """Per-level operator data, coarsest..finest, for both blocks, from
    the cell-first fine element matrices `jac_fine` and the fine
    LevelGeom.  Returns (level_ops, reuse_out), reuse_out = (jacs,
    u_data): the RAP chain and the u-block masks, diagonals and spectra,
    none of which depends on the active set.  Passed back as `reuse`
    with the SAME element matrices it skips the coarsening and the
    u-block data; only the phase-field block is rebuilt."""
    levels = hier.levels
    geoms = [lvl.geom for lvl in levels] + [fine]
    injects = [lvl.inject_p for lvl in levels]
    if reuse is None:
        # on W ranks the chain starts from every rank's fine matrices,
        # gathered: each rank coarsens all of them (ROADMAP A11e part 2)
        jacs = list(fine.cs.all_cells(jac_fine, axis=0))
        for lvl in reversed(levels):
            jacs.insert(0, coarsen_level(jacs[0], lvl, hier.P_embed,
                                         lvl.geom.gather_p.shape[0]))
        jacs[-1] = jac_fine
        jacs = tuple(jacs)
        u_data = _level_blockdata(jacs, geoms, injects, active, "u",
                                  dim=dim, sharp=sharp)
    else:
        jacs, u_data = reuse
    p_data = _level_blockdata(jacs, geoms, injects, active, "p", dim=dim,
                              sharp=sharp)
    rng = smoothing_range(sharp)
    dt = jac_fine.dtype
    out = []
    for i, jac in enumerate(jacs):
        up_u = up_p = None
        if i < len(levels):
            lvl = levels[i]
            up_u = (lvl.up_masters_u, lvl.up_weights_u.to(dt),
                    lvl.up_scatter_u)
            up_p = (lvl.up_masters_p, lvl.up_weights_p.to(dt),
                    lvl.up_scatter_p)
        out.append(_LevelOps(jac, geoms[i], u_data[i][0], p_data[i][0],
                             u_data[i][1], p_data[i][1], u_data[i][2],
                             p_data[i][2], up_u, up_p, rng))
    return tuple(out), (jacs, u_data)


def _pieces(lv: _LevelOps, which: str, dim: int):
    """(operator, free, Dinv, lam, con) of one block on one level."""
    g = lv.geom
    if which == "u":
        gather, st, free, Dinv, lam = (g.gather_u, g.scatter_u, lv.free_u,
                                       lv.Dinv_u, lv.lam_u)
    else:
        gather, st, free, Dinv, lam = (g.gather_p, g.scatter_p, lv.free_p,
                                       lv.Dinv_p, lv.lam_p)
    op = _masked_op(_block(lv.jac, which, dim), gather, st, free, g.con,
                    which, g.cs)
    return op, free, Dinv, lam, g.con


def _coarse_factor(lv0: _LevelOps, which: str, dim: int):
    """(L, s): the f64 Cholesky factor of the coarsest level's condensed
    block, Jacobi-scaled and shifted by 1e-5 (s A s + 1e-5 I = L L^T on
    the free dofs, the identity elsewhere).  The crack strip's ~1e8
    coefficient contrast breaks an f32 factor, and with K reg = 0 the
    fully cracked u block is singular: the scaling and the shift keep
    the factor finite (a failed factor is NaN, as in JAX)."""
    f64 = torch.float64
    g = lv0.geom
    free = lv0.free_u if which == "u" else lv0.free_p
    gather = g.gather_u if which == "u" else g.gather_p
    n0 = free.shape[0]
    keys = gather[:, :, None] * n0 + gather[:, None, :]
    A0 = scatter_add(scatter_table(keys), _block(lv0.jac, which, dim),
                     lv0.jac.new_zeros(n0 * n0)).view(n0, n0)
    con = g.con
    if which == "u":
        child, masters, w = (con.hang_child_u, con.hang_masters_u,
                             con.hang_weights_u)
    else:
        child, masters, w = (con.hang_child_p, con.hang_masters_p,
                             con.hang_weights)
    m = free.to(A0.dtype)
    if child.numel():
        # condense with a dense C: rows of hanging children from their
        # masters, constrained columns dropped
        C = torch.diag(m)
        ck = child[:, None] * n0 + masters
        scatter_add(scatter_table(ck), w.to(A0.dtype), C.view(-1))
        C = C * m[None, :]
        A0 = C.T @ (A0 @ C)
    A0 = torch.where(free[:, None] & free[None, :], A0, 0.0)
    A0 = (A0 + torch.diag(1.0 - m)).to(f64)
    s = 1.0 / torch.sqrt(torch.diagonal(A0).abs())
    A0s = A0 * s[:, None] * s[None, :]
    A0s = A0s + 1e-5 * torch.eye(n0, dtype=f64, device=A0.device)
    L, info = torch.linalg.cholesky_ex(A0s)
    return torch.where(info == 0, L, math.nan), s


def make_vcycle(level_ops, *, dim: int, which: str,
                degree: int = CHEB_DEGREE):
    """V-cycle application M^-1 b for one block: Chebyshev pre- and
    post-smoothing above the coarsest level, restriction through each
    coarser level's hanging constraints (the transpose of distributing
    on the coarse level, then interpolating up) and the coarsest level
    solved by the f64 Cholesky factor."""
    pieces = [_pieces(lv, which, dim) for lv in level_ops]
    L, s = _coarse_factor(level_ops[0], which, dim)
    interp, transpose = _hang(which)

    def cycle(l, b):
        op, free, Dinv, lam, _ = pieces[l]
        b = torch.where(free, b, 0.0)
        if l == 0:
            bs = (s * b.to(torch.float64))[:, None]
            x = s * torch.cholesky_solve(bs, L)[:, 0]
            return torch.where(free, x.to(b.dtype), 0.0)
        rng = level_ops[l].rng
        x = _chebyshev(op, Dinv, b, lam, degree, rng)
        r = b - op(x)
        lvc = level_ops[l - 1]
        mast, wts, st = lvc.up_u if which == "u" else lvc.up_p
        _, free_c, _, _, con_c = pieces[l - 1]
        r_c = transpose(_restrict(r, mast, wts, st, free_c.shape[0]), con_c)
        e_c = cycle(l - 1, r_c)
        x = x + torch.where(free, _prolong(interp(e_c, con_c), mast, wts),
                            0.0)
        r = b - op(x)
        return x + _chebyshev(op, Dinv, r, lam, degree, rng)

    top = len(level_ops) - 1
    return lambda b: cycle(top, b)


# ---------------------------------------------------------------------------
# preconditioned CG with the exit test on the card
# ---------------------------------------------------------------------------

class _CG(NamedTuple):
    X: torch.Tensor
    R: torch.Tensor
    Pv: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor       # |R|^2 of the current iterate
    k: torch.Tensor        # iterations taken
    Xb: torch.Tensor       # the iterate of least |R|^2 so far
    rrb: torch.Tensor
    kb: torch.Tensor       # the iteration that found it
    live: torch.Tensor     # whether the loop goes on


def _cg_start(M, R0, rrb0):
    """The state before the first iteration from x = 0, with the least
    |R|^2 so far set to `rrb0`."""
    Z = M(R0)
    zero = torch.zeros((), dtype=torch.int64, device=R0.device)
    return _CG(torch.zeros_like(R0), R0, Z, torch.dot(R0, Z),
               torch.dot(R0, R0), zero, torch.zeros_like(R0), rrb0, zero,
               torch.ones((), dtype=torch.bool, device=R0.device))


def _cg_step(op, M, s: _CG, live_fn) -> _CG:
    """One PCG iteration that changes the state only where s.live."""
    live = s.live
    Ap = op(s.Pv)
    denom = torch.dot(s.Pv, Ap)
    alpha = torch.where(denom != 0, s.rz / denom, 0.0)
    X = torch.where(live, s.X + alpha * s.Pv, s.X)
    R = torch.where(live, s.R - alpha * Ap, s.R)
    rr = torch.dot(R, R)
    k = s.k + live.to(torch.int64)
    better = live & (rr < s.rrb)
    Z = M(R)
    rz_new = torch.dot(R, Z)
    beta = torch.where(s.rz != 0, rz_new / s.rz, 0.0)
    Pv = torch.where(live, Z + beta * s.Pv, s.Pv)
    s = _CG(X, R, Pv, torch.where(live, rz_new, s.rz), rr, k,
            torch.where(better, X, s.Xb), torch.where(better, rr, s.rrb),
            torch.where(better, k, s.kb), live)
    return s._replace(live=live & live_fn(s))


def _cg_run(op, M, s: _CG, live_fn, max_steps: int) -> _CG:
    """Advance while live_fn holds, tested before every iteration as a
    while loop does (at most max_steps iterations), reading the flag
    every CHECK_EVERY iterations."""
    s = s._replace(live=live_fn(s))
    n = 0
    while n < max_steps and bool(s.live):
        for _ in range(min(CHECK_EVERY, max_steps - n)):
            s = _cg_step(op, M, s, live_fn)
            n += 1
    return s


# ---------------------------------------------------------------------------
# the f64 Galerkin-preconditioned block CG
# ---------------------------------------------------------------------------

def solve_cg_block(hier: GalerkinHierarchy, jac, fine: LevelGeom, ca, cs,
                   con, active, rhs_u, rhs_p, rtol, atol, *, dim: int,
                   maxiter: int, chunk: int, degree: int = CHEB_DEGREE):
    """Galerkin-GMG-preconditioned block-triangular CG on the stored f64
    element matrices `jac` (cell-last, as `assembled.build_jacobians`
    returns them): A_uu du = b_u, then A_pp dp = b_p - A_pu du (the
    AMG+GMRES analogue, cracks.cc:2762-2771).  Each block runs up to
    four restarted passes, each to 1e-6 relative on the exact residual;
    a pass advances in chunks of `chunk` iterations and stops after two
    chunks that do not halve its least |r|^2.  Returns (du, dp,
    iterations) on the free subspace."""
    jac_cf = jac.permute(2, 0, 1).contiguous()
    level_ops, _ = build_level_ops(
        hier, jac_cf, fine, active, dim=dim,
        sharp=sharp_spectrum(active.shape[0] * (dim + 1)))
    eps = torch.finfo(jac.dtype).eps

    def run_block(which, b):
        op, free, _, _, _ = _pieces(level_ops[-1], which, dim)
        M = make_vcycle(level_ops, dim=dim, which=which, degree=degree)
        bnorm = math.sqrt(float(torch.dot(b, b)))
        # the overall target, floored at ~100 eps relative (below it CG
        # stagnates on rounding noise while the iterate drifts)
        target2 = max(rtol * bnorm, atol, 100.0 * eps * bnorm) ** 2
        x_acc = torch.zeros_like(b)
        r_cur = b
        rr_cur = bnorm * bnorm
        its = 0
        for _ in range(4):
            tol2 = max(math.sqrt(rr_cur) * max(rtol, 1e-6),
                       math.sqrt(target2)) ** 2
            s = _cg_start(M, r_cur, torch.tensor(rr_cur, dtype=b.dtype,
                                                 device=b.device))
            rr = rr_cur
            stalled = False
            stalls = 0
            while rr > tol2 and int(s.k) < maxiter - its:
                prev_rr = rr
                k0 = s.k
                s = _cg_run(op, M, s, lambda t, k0=k0: (t.rr > tol2)
                            & (t.k - k0 < chunk), chunk)
                rr = float(s.rrb)
                if not math.isfinite(rr):
                    stalled = True      # blew up: keep the best iterate
                    break
                # one non-halving chunk can be a plateau of the
                # ill-conditioned fracture operator; two in a row stall
                stalls = stalls + 1 if rr > 0.5 * prev_rr else 0
                if stalls >= 2:
                    stalled = True
                    break
            its += int(s.k)
            x_try = x_acc + s.Xb
            r_try = b - op(x_try)
            rr_try = float(torch.dot(r_try, r_try))
            if not math.isfinite(rr_try) or rr_try >= rr_cur:
                break               # no progress: keep the accumulate
            progress = rr_try / max(rr_cur, 1e-300)
            x_acc, r_cur, rr_cur = x_try, r_try, rr_try
            if rr_cur <= target2 or its >= maxiter:
                break
            if stalled and progress > 1e-4:
                break               # the arithmetic floor
        return x_acc, its

    du, it_u = run_block("u", rhs_u)
    rhs_p2 = assembled._coupling_rhs(jac, ca, con, active, cs, du, rhs_p,
                                     dim=dim)
    dp, it_p = run_block("p", rhs_p2)
    return du, dp, it_u + it_p


# ---------------------------------------------------------------------------
# the mixed-precision split solve
# ---------------------------------------------------------------------------

def _g_jac32(sys, u, phi, phi_old, phi_oold, with_split):
    """f32 element Jacobians at the Newton point, built from f32 inputs
    (cell-first); f64 matrices are never built."""
    f32 = lambda x: x.to(torch.float32)
    jac = physics.element_matrices(
        f32(u), f32(phi), f32(phi_old), f32(phi_oold), sys.ca32,
        physics.Scalars(*(f32(v) for v in sys.scalars)), dim=sys.dim,
        with_split=with_split, monolithic=sys.monolithic,
        cs=sys.cell_scatter)
    return jac.permute(2, 0, 1).contiguous()


def _g_pass_setup(free, r, rtol, target2):
    """f64 -> f32 boundary of one CG pass: the normalized f32 residual,
    its scale and the pass tolerance (3e-7 relative at best: an f64
    refinement pass is one jvp of the residual assembly, so the f32 pass
    digs as deep as single precision allows)."""
    rr0 = torch.dot(r, r)
    scale = torch.sqrt(rr0)
    inv_scale = torch.where(scale > 0, 1.0 / scale, 0.0)
    R0 = torch.where(free, (r * inv_scale).to(torch.float32), 0.0)
    tol2 = torch.where(rr0 > 0, target2 / rr0, 1.0).clamp_min(
        max(rtol, 3e-7) ** 2).to(torch.float32)
    return R0, scale, tol2


def _g_cg_pass32(op32, M32, R0, tol2, *, inner_max=INNER_MAX,
                 stall_window=STALL_WINDOW):
    """One all-f32 Galerkin-GMG CG pass on the normalized residual:
    (best iterate, iterations).  It stops when the pass target is met,
    after inner_max iterations, or when no new best residual appeared
    within `stall_window` iterations (the f32 floor)."""
    def live_fn(s):
        return (s.rrb > tol2) & (s.k < inner_max) & (s.k - s.kb
                                                    < stall_window)
    s = _cg_start(M32, R0, torch.ones((), dtype=R0.dtype, device=R0.device))
    s = _cg_run(op32, M32, s, live_fn, inner_max)
    return s.Xb, s.k


def _g_pass_apply(sys, u, phi, phi_old, phi_oold, con, active, Xb, scale,
                  x_acc, b, which, with_split):
    """f32 -> f64 boundary of one CG pass: the trial accumulate, the
    EXACT f64 Newton operator applied to it as one jvp of the f64
    element residual at the Newton point, scattered in order
    (`physics.jacobian_vector_product`), and the trial residual.
    Returns (x_try, r_try, rr_try, J_pu x_try for 'u' else None)."""
    x_try = x_acc + Xb.to(torch.float64) * scale
    zu = torch.zeros_like(u)
    zp = torch.zeros_like(phi)
    eu, ep = expand_update(x_try if which == "u" else zu,
                           zp if which == "u" else x_try, con, active)
    ju, jp = physics.jacobian_vector_product(
        u, phi, eu, ep, phi_old, phi_oold, sys.ca, sys.scalars,
        sys.cell_scatter, dim=sys.dim, with_split=with_split,
        monolithic=sys.monolithic)
    ju, jp = condense_residual(ju, jp, con, active)
    r_try = b - (ju if which == "u" else jp)
    return x_try, r_try, torch.dot(r_try, r_try), (jp if which == "u"
                                                    else None)


def block_target(bnorm: float, rtol: float, newton_lower_bound: float,
                 n_dofs: int) -> float:
    """A block's residual target in `solve_split`: JAX's fused solve's
    max(rtol |b|, 100 eps |b|) (``cracks_tpu/solvers/galerkin.py:651``)
    up to FUSED_SOLVE_MAX_DOFS, and above it JAX's split solve's, which
    adds the floor 1e-3 x the Newton lower bound
    (``cracks_tpu/solvers/galerkin.py:1125-1127``)."""
    eps64 = float(np.finfo(np.float64).eps)
    target = max(rtol * bnorm, 100.0 * eps64 * bnorm)
    if n_dofs > FUSED_SOLVE_MAX_DOFS:
        target = max(target, 1e-3 * newton_lower_bound)
    return target


def solve_split(sys, hier: GalerkinHierarchy, u, phi, phi_old, phi_oold,
                con, active, rhs_u, rhs_p, with_split, passes: int = 16):
    """The mixed-precision Galerkin solve: per block up to `passes`
    restarted refinement passes, each an all-f32 GMG-preconditioned CG
    on the normalized residual followed by the exact f64 residual.  The
    f32 element matrices are cached at the point where they were built
    (`opcache`, JAC_RTOL), and at production sizes (the sharp spectral
    window) the RAP chain and the u-block level data ride that cache.
    Returns (du, dp, iterations) on the free subspace."""
    p = sys.params
    rtol = p.cg_rtol
    dim = sys.dim
    n_dofs = sys.mesh.n_dofs
    sharp = sharp_spectrum(n_dofs)
    ctx = (u, phi, phi_old, phi_oold, opcache.scalars_vec(sys.scalars))
    flags = (with_split, sys.monolithic)
    jac32 = opcache.lookup(sys._galerkin_jac_cache, ctx, flags, JAC_RTOL)
    if jac32 is None:
        # drop the stale operator and its level data before building
        sys._galerkin_jac_cache = None
        sys._galerkin_levels_cache = None
        jac32 = _g_jac32(sys, u, phi, phi_old, phi_oold, with_split)
        sys._galerkin_jac_cache = (ctx, flags, jac32)
    lv = sys._galerkin_levels_cache
    reuse = lv[1] if lv is not None and lv[0] is jac32 else None
    level_ops, reuse_out = build_level_ops(hier, jac32, sys.galerkin_fine,
                                           active, dim=dim, sharp=sharp,
                                           reuse=reuse)
    sys._galerkin_levels_cache = (jac32, reuse_out) if sharp else None
    total_its = 0
    last_jp = None

    def block(which, b):
        nonlocal total_its, last_jp
        bnorm = math.sqrt(float(torch.dot(b, b)))
        target2 = block_target(bnorm, rtol, p.lower_bound_newton_residual,
                               n_dofs) ** 2
        if bnorm * bnorm <= target2:
            return torch.zeros_like(b)
        op32, free, _, _, _ = _pieces(level_ops[-1], which, dim)
        M32 = make_vcycle(level_ops, dim=dim, which=which)
        target2_d = torch.tensor(target2, dtype=torch.float64,
                                 device=b.device)
        x_acc = torch.zeros_like(b)
        r_cur = b
        rr_cur = bnorm * bnorm
        for _ in range(passes):
            if rr_cur <= target2:
                break
            R0, scale, tol2 = _g_pass_setup(free, r_cur, rtol, target2_d)
            Xb, k = _g_cg_pass32(op32, M32, R0, tol2)
            x_try, r_try, rr_try, jp = _g_pass_apply(
                sys, u, phi, phi_old, phi_oold, con, active, Xb, scale,
                x_acc, b, which, with_split)
            k = int(k)
            total_its += k
            rr_try = float(rr_try)
            if not math.isfinite(rr_try) or rr_try >= rr_cur:
                break
            progress = rr_try / max(rr_cur, 1e-300)
            x_acc, r_cur, rr_cur = x_try, r_try, rr_try
            if which == "u":
                last_jp = jp
            # little progress on a pass that did NOT reach its cap is the
            # f32 floor; a capped pass just needs more passes
            if rr_cur <= target2 or (progress > 0.25 and k < INNER_MAX):
                break
        return x_acc

    du = block("u", rhs_u)
    dp = block("p", rhs_p if last_jp is None else rhs_p - last_jp)
    return du, dp, total_its
