"""Tensor-grid (monolattice) lattice GMG solve of the Newton system.

Port of the single-device part of ``cracks_tpu/solvers/lattice.py``.
On a uniformly refined tensor-product mesh (Sneddon's ``rect_mesh``
roots, ``n_global_pre_refine`` refinements, no hanging nodes) the mesh
IS a global (GY, GX) or (GZ, GY, GX) lattice and every FEM
gather/scatter is a shifted slice:

  * cell->vertex gather = 2**dim shifted cell-grid windows;
  * vertex scatter-add  = 2**dim shifted window adds;
  * 2:1 restriction/prolongation = strided slices, separable per axis;
  * Galerkin element-RAP coarsening = [o::2] slices + contraction with
    the constant embedding matrices;
  * the active-set injection to level l = [::2**l].

A 2d mesh cut by one horizontal slit to the +x boundary (the
``unit_slit.inp`` family of the Miehe cases), whose lip vertices are
duplicated, is embedded the same way with a `Seam`: one extra vertex
row for the upper lip and one dead cell row between the lips, every
stencil product conjugated as collect . product . spread.

Lattice vectors are (comp, *grid) with comp leading; element data is
(ndl, ndl, *cellgrid).  Every stencil product goes through
`ops.stencil.stencil_matvec` (the 2d or 3d CUDA kernel on the card).

The solve is ONE algorithm, the JAX package's split variant
(`_solve_split`, and `_solve_split_lat` on lattice-layout state):
exact f64 element matrices built once per Newton solve; their f32
cast, Galerkin-coarsened, feeds a float32 CG preconditioned by a
Chebyshev-smoothed V-cycle; f64 refinement passes correct the f32
iterate with the stored f64 operator.  It runs on lattice-layout state
(`solve_lattice_lat`, whose vectors may carry zero pad rows up to the
sharded extent gyp, ``parallel/sharding.py``); `solve_lattice` is its
flat-vector entry for the replicated Newton.  With a shard mesh the
f32 fine-level operator of the CG loop and the V-cycle is the sharded
product (`ops.stencil.stencil_matvec_sharded`, one launch for all
shards of a process), seam lattices included.

On a shard mesh the hierarchy is split by slab
(`parallel.sharding.level_slabs`, the hierarchy's `slabs`): a process
holds its rows of every vector and mask of the finest `n_split` levels
and the element matrices of the cells next to them, and each level's
product, transfer, diagonal and spectral bound works on the process's
rows and one exchanged halo row each way (`Slab.ext`); the f64
refinement products too.  Coarsening a level takes at most one coarse
cell row from a neighbour (`coarsen_slab`).  The levels below are whole
on every process: one gather of the first one's operator per setup and
of its restricted residual per V-cycle, after which every process runs
them, and the coarse factor, identically.  A seam lattice splits the
same way: its transfers and coarsening work per lip on a slab, the
spread follows the halo exchange (`seam_ext`), and where the seam runs
between two ranks the collect takes one exchange between them
(`seam_collect_rows`).  Every dot product of the solve, one process or
D shards or W ranks alike, is a sum of per-row partial sums
(`Slab.dots`), so all of them hold the same bits: the replicated
Newton's solve takes one slab of all rows per level in one process, and
its rank's slabs on W ranks of the replicated cell-axis mode
(`solve_lattice`); only the module's functions called without a slab
keep the global view.  The element residual, the element matrices and
the Galerkin coarsening contract in pieces of a number of cell rows set
by the whole level (`CELL_CHUNK`, `RESIDUAL_CHUNK`; across a seam each
lip's), so a cell has the same bits whatever rows a process holds.  The global
transfers and coarsening of a seam lattice are the slab forms on whole
levels (`sharding.whole`).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import physics
from ..ops.stencil import (halo_rows, pad_jac_sharded, stencil_matvec,
                           stencil_matvec_sharded)
from ..parallel import dist
from ..parallel.sharding import (Slab, coarse_rows_below, gather_rows,
                                 level_slabs, pad_rows, unpad_rows, whole)
from .galerkin import embedding_matrices
from . import opcache
from .multigrid import _chebyshev, sharp_spectrum, smoothing_range


@lru_cache(maxsize=None)
def _offsets(dim: int) -> tuple:
    """Corner a -> per-grid-axis offsets, grid axes ordered slowest to
    fastest (z, y, x).  Local vertex a has reference coordinate along
    geometric axis d equal to (a >> d) & 1, and grid axis j is
    geometric axis dim-1-j."""
    return tuple(
        tuple(((a >> (dim - 1 - j)) & 1) for j in range(dim))
        for a in range(2 ** dim))


def _win(o, G):
    """Index tuple selecting the shifted cell-grid window at corner
    offset o of a (*, *G) vertex-lattice array."""
    return (slice(None),) + tuple(
        slice(o[j], G[j] - 1 + o[j]) for j in range(len(G)))


def _every_other(ndim: int):
    """Index tuple of the [::2] injection on every grid axis of a
    (k, *grid) array."""
    return (slice(None),) + (slice(None, None, 2),) * ndim


def _dot(a, b):
    return torch.sum(a * b)




# ---------------------------------------------------------------------------
# the seam of a slit lattice
# ---------------------------------------------------------------------------

class Seam(NamedTuple):
    """A horizontal slit cut into a 2d vertex lattice, from the domain's
    interior to the +x boundary, whose lip vertices are duplicated (the
    reference's ``unit_slit.inp`` family, cracks.cc:1202-1205).

    The lattice duplicates the whole slit row: vertex row `s` carries
    the lower lip, row s+1 the upper lip, and at the glued columns
    [0, slit_lo), where the material is continuous, both rows stand for
    the SAME DoF.  The cell raster gains one dead row (index s, zero
    element matrices) between the lips, so the cell->vertex gather stays
    a shifted window on both sides of the cut.

    DoF vectors stay in canonical form: the shared value lives in row s
    and the mirror entries (row s+1, glued columns) are zero, so a dot
    product counts each DoF once.  Every stencil product is conjugated
    as collect . product . spread, that is S^T A S for the duplication
    map S."""

    s: int        # lower-lip vertex row (grid axis 0); mirror row s+1
    slit_lo: int  # first duplicated column; glued columns [0, slit_lo)


def seam_spread(X, seam: Seam | None, r0: int = 0):
    """Canonical -> consistent: copy the shared values of row s into the
    mirror slots (row s+1, glued columns), so the stencil sees the
    function on both sides of the seam.  A slice copy: the JAX
    package's one-hot matmul form serves only its SPMD partitioner, and
    each output element is the same copy.  X holds the rows [r0, r0 +
    X.shape[1]) of its level (all of them by default); where it lacks
    either lip row it is returned as it is (`seam_ext` spreads across a
    rank boundary)."""
    if seam is None:
        return X
    s, lo = seam
    i = s - r0
    if not 0 <= i < X.shape[1] - 1:
        return X
    Y = X.clone()
    Y[:, i + 1, :lo] = X[:, i, :lo]
    return Y


def _straddles(seam: Seam | None, sl: Slab | None) -> bool:
    """Whether a rank boundary of the slab's level runs between the lip
    rows s and s+1: this process owns one of them, a neighbour the
    other."""
    return (seam is not None and sl is not None and sl.ranked
            and seam.s + 1 in (sl.a, sl.b))


def seam_ext(sl: Slab | None, seam: Seam | None, *Xs):
    """Canonical owned rows -> consistent halo'd rows (`Slab.ext`): the
    spread where this process owns both lip rows (so a boundary row it
    sends is consistent), the exchange, and, where the seam straddles a
    rank boundary, the spread again on the halo'd rows, which hold both
    lip rows only after the exchange.  Without a slab, the spread of
    whole levels.  Returns a tuple."""
    if sl is None:
        return tuple(seam_spread(X, seam) for X in Xs)
    Es = sl.ext(*(seam_spread(X, seam, sl.a) for X in Xs))
    if _straddles(seam, sl):
        Es = tuple(seam_spread(E, seam, sl.e0) for E in Es)
    return Es


def seam_collect(Y, seam: Seam | None, sl: Slab | None = None):
    """Consistent -> canonical (the S^T of seam_spread): add the mirror
    slots into the shared row and zero them.  With a slab `sl`, Y holds
    its owned rows (`seam_collect_rows`)."""
    return seam_collect_rows((Y,), seam, sl)[0]


def seam_collect_rows(Ys, seam: Seam | None, sl: Slab | None = None):
    """`seam_collect` of the owned rows of a slab of one or more arrays
    of one dtype and row shape (whole levels without `sl`).  Where the
    seam straddles a rank boundary the owner of the mirror row s+1 sends
    its glued columns of all of them to the owner of row s in one
    exchange between those two ranks (counted apart,
    `dist.EXCHANGES["seam"]`) and zeroes them; the owner of s adds them.
    Every other process moves nothing.  Returns a tuple."""
    if seam is None:
        return tuple(Ys)
    s, lo = seam
    a = 0 if sl is None else sl.a
    n = Ys[0].shape[1]
    own_s, own_m = 0 <= s - a < n, 0 <= s + 1 - a < n
    out = [Y.clone() for Y in Ys] if own_s or own_m else list(Ys)
    if own_s and own_m:
        for Y, Z in zip(Ys, out):
            Z[:, s - a, :lo] = Y[:, s - a, :lo] + Y[:, s + 1 - a, :lo]
            Z[:, s + 1 - a, :lo] = 0.0
    elif own_m:
        dist.exchange_rows(sl.mesh.ranks,
                           down=torch.cat([Y[:, :1, :lo] for Y in Ys]),
                           seam=True)
        for Z in out:
            Z[:, 0, :lo] = 0.0
    elif own_s:
        ks = [Y.shape[0] for Y in Ys]
        _, got = dist.exchange_rows(
            sl.mesh.ranks, from_above=((sum(ks), 1, lo), Ys[0].dtype),
            seam=True)
        at = 0
        for Y, Z, k in zip(Ys, out, ks):
            Z[:, n - 1, :lo] = Y[:, n - 1, :lo] + got[at:at + k, 0]
            at += k
    return tuple(out)


def seam_coarse(seam: Seam | None) -> Seam | None:
    """The seam of the 2:1-coarsened lattice.  Needs s even (the slit
    line lies on the coarse grid) and slit_lo odd (ceil keeps every
    glued fine midpoint interpolated from two glued coarse nodes, which
    makes the per-slab element RAP exactly the Galerkin operator)."""
    if seam is None:
        return None
    assert seam.s % 2 == 0 and seam.slit_lo % 2 == 1
    return Seam(s=seam.s // 2, slit_lo=(seam.slit_lo + 1) // 2)


def _seam_can_coarsen(grid, seam: Seam | None) -> bool:
    if seam is None:
        return all((g - 1) % 2 == 0 for g in grid)
    gy, gx = grid
    return ((gy - 2) % 2 == 0 and (gx - 1) % 2 == 0
            and seam.s % 2 == 0 and seam.s >= 2 and seam.slit_lo % 2 == 1)


def _seam_coarse_grid(grid, seam: Seam | None) -> tuple:
    if seam is None:
        return tuple((g - 1) // 2 + 1 for g in grid)
    return ((grid[0] - 2) // 2 + 2, (grid[1] - 1) // 2 + 1)


def _seam_inject_down(A, seam: Seam | None):
    """One-level injection of a (k, *grid) lattice field (a tensor or a
    host array) to the coarse lattice: [::2] on every grid axis, or,
    across a seam, per slab (the mirror row s+1 starts the upper slab,
    so both lips inject to their coarse lips)."""
    if seam is None:
        return A[_every_other(A.ndim - 1)]
    cat = np.concatenate if isinstance(A, np.ndarray) else torch.cat
    s = seam.s
    return cat([A[:, 0:s + 1:2], A[:, s + 1::2]], 1)[:, :, ::2]


def seam_levels(seam: Seam | None, n_levels: int) -> tuple:
    """Per-level seams, coarsest..finest."""
    out = [seam]
    for _ in range(n_levels - 1):
        out.insert(0, seam_coarse(out[0]))
    return tuple(out)


# ---------------------------------------------------------------------------
# host setup
# ---------------------------------------------------------------------------

class LatticeLayout(NamedTuple):
    """Host-built tensor-grid identification of a MeshData."""

    grid: tuple             # vertex extents, slowest..fastest (y,x)/(z,y,x)
    vert_idx: np.ndarray    # (*grid) int32 global vertex id per node
    vert_pos: np.ndarray    # (n_v,) int32 flat lattice pos per vertex
    cell_perm: np.ndarray   # (n_cells,) raster -> mesh cell id; -1 =
    #                         dead raster slots (a seam lattice's row s)
    seam: Seam | None = None


def _product_grid(mesh):
    """(grid, per-grid-axis vertex index, flat grid position per vertex)
    when the vertex coordinates take few enough distinct values per axis
    to form a product grid of at least 4 per axis, else None.  Grid
    axes are ordered slowest to fastest (z, y, x).  On a slit mesh two
    vertices share each duplicated lip position."""
    dim = mesh.dim

    def axis_index(vals):
        """Cluster coordinates that differ only by multilinear-map
        float noise across roots; returns (index per value, count)."""
        s = np.sort(np.unique(vals))
        span = s[-1] - s[0]
        if span <= 0:
            return None
        tol = 1e-9 * span
        brk = np.diff(s) > tol
        cid = np.r_[0, np.cumsum(brk)]
        if len(s) > 1 and np.diff(s)[brk].min(initial=np.inf) < 100 * tol:
            return None
        idx = cid[np.searchsorted(s, vals)]
        return idx, cid[-1] + 1

    res = [axis_index(mesh.vert_coords[:, d]) for d in range(dim)]
    if any(r is None for r in res):
        return None
    gidx = [r[0] for r in res][::-1]          # per grid axis
    grid = tuple(int(r[1]) for r in res)[::-1]
    if min(grid) < 4:
        return None
    pos = np.zeros(mesh.n_vertices, np.int64)
    for j in range(dim):
        pos = pos * grid[j] + gidx[j]
    return grid, gidx, pos


def detect_tensor_grid(mesh) -> LatticeLayout | None:
    """Identify a mesh whose vertices form an exact tensor grid (2d or
    3d), or, in 2d, a tensor grid cut by one horizontal slit whose lip
    vertices are duplicated (`_detect_slit_grid`: a layout with a
    `Seam` and one dead cell row).  Anything else returns None: hanging
    nodes, unstructured meshes."""
    if mesh.dim not in (2, 3) or len(mesh.hang_child):
        return None
    dim = mesh.dim
    pg = _product_grid(mesh)
    if pg is None:
        return None
    grid, gidx, pos = pg
    nv = mesh.n_vertices
    if int(np.prod(grid)) != nv or len(np.unique(pos)) != nv:
        if dim == 2 and int(np.prod(grid)) < nv:
            return _detect_slit_grid(mesh, grid, gidx, pos)
        return None
    vert_idx = np.full(int(np.prod(grid)), -1, np.int64)
    vert_idx[pos] = np.arange(nv)
    if (vert_idx < 0).any():
        return None
    vert_idx = vert_idx.reshape(grid)

    # cells: locate each cell by its first (lexicographically lowest)
    # vertex; require the full cell raster and the fem.py corner order
    cgrid = tuple(g - 1 for g in grid)
    if mesh.n_cells != int(np.prod(cgrid)):
        return None
    ll = mesh.cell2vert[:, 0]
    cpos = np.array(np.unravel_index(pos[ll], grid))   # (dim, n_c)
    offs = _offsets(dim)
    expect = np.stack([
        vert_idx[tuple(cpos[j] + o[j] for j in range(dim))]
        for o in offs], axis=1)
    if not (expect == mesh.cell2vert).all():
        return None
    craster = np.zeros(mesh.n_cells, np.int64)
    for j in range(dim):
        craster = craster * cgrid[j] + cpos[j]
    raster = np.full(int(np.prod(cgrid)), -1, np.int64)
    raster[craster] = np.arange(mesh.n_cells)
    if (raster < 0).any():
        return None
    return LatticeLayout(grid=grid,
                         vert_idx=vert_idx.astype(np.int32),
                         vert_pos=pos.astype(np.int32),
                         cell_perm=raster.astype(np.int32))


def _detect_slit_grid(mesh, grid0, gidx, pos0) -> LatticeLayout | None:
    """The seam branch of detect_tensor_grid: the vertex coordinates form
    a (gy0, gx0) product grid but some positions carry TWO vertices, the
    duplicated lips of a horizontal slit.  Accepts exactly the
    reference's slit pattern (one slit row, duplicated columns
    contiguous to the +x boundary) and embeds it as a (gy0+1, gx0)
    lattice with a `Seam`.  Every structural assumption is checked; any
    mismatch returns None (the caller then takes the Galerkin GMG)."""
    gy0, gx0 = grid0
    nv = mesh.n_vertices
    ri, ci = gidx                                      # row, col per vertex
    uniq, counts = np.unique(pos0, return_counts=True)
    if counts.max() != 2 or len(uniq) != gy0 * gx0:
        return None
    dup = uniq[counts == 2]
    rows = dup // gx0
    if len(np.unique(rows)) != 1:
        return None
    s0 = int(rows[0])
    if not (1 <= s0 <= gy0 - 2):
        return None
    cols = np.sort(dup % gx0)
    lo = int(cols[0])
    # contiguous duplicated columns reaching the +x boundary
    if lo < 1 or not (cols == np.arange(lo, gx0)).all():
        return None

    # each lip copy by its cell corner role: fem.py's corners 0, 1 are
    # cell bottoms, 2, 3 cell tops; a lip vertex that is only ever a
    # top corner belongs to the cells below the slit, the LOWER lip
    c2v = mesh.cell2vert
    top = np.zeros(nv, bool)
    bot = np.zeros(nv, bool)
    bot[c2v[:, :2]] = True
    top[c2v[:, 2:]] = True
    is_dup = np.isin(pos0, dup)
    lower = is_dup & top & ~bot
    upper = is_dup & bot & ~top
    if not ((lower | upper) == is_dup).all():
        return None
    if not (np.sum(lower) == np.sum(upper) == gx0 - lo):
        return None

    # the expanded lattice: one more row; the lower lip and the glued
    # vertices stay on row s0, the upper lip moves to row s0+1, the rows
    # above shift up by one
    gy = gy0 + 1
    grid = (gy, gx0)
    row_new = np.where(ri > s0, ri + 1, ri).astype(np.int64)
    row_new = np.where(upper, s0 + 1, row_new)
    pos = row_new * gx0 + ci
    if len(np.unique(pos)) != nv:
        return None
    vert_idx = np.full(gy * gx0, -1, np.int64)
    vert_idx[pos] = np.arange(nv)
    vert_idx = vert_idx.reshape(grid)
    # the consistent view: the mirror slots alias the shared vertex
    vic = vert_idx.copy()
    vic[s0 + 1, :lo] = vic[s0, :lo]
    if (vic < 0).any():
        return None

    # cells: the row from the top-left corner (strictly above the slit
    # for the cells above it, so the dead raster row s0 stays empty),
    # the column from the bottom-left corner
    r_c = row_new[c2v[:, 2]] - 1
    c_c = ci[c2v[:, 0]].astype(np.int64)
    cgrid = (gy - 1, gx0 - 1)
    if ((r_c < 0) | (r_c >= cgrid[0]) | (c_c < 0) | (c_c >= cgrid[1])).any():
        return None
    expect = np.stack([vic[r_c + o[0], c_c + o[1]] for o in _offsets(2)],
                      axis=1)
    if not (expect == c2v).all():
        return None
    raster = np.full(cgrid[0] * cgrid[1], -1, np.int64)
    raster[r_c * cgrid[1] + c_c] = np.arange(mesh.n_cells)
    dead = raster.reshape(cgrid) < 0
    if not (dead == (np.arange(cgrid[0])[:, None] == s0)).all():
        return None
    return LatticeLayout(grid=grid,
                         vert_idx=vert_idx.astype(np.int32),
                         vert_pos=pos.astype(np.int32),
                         cell_perm=raster.astype(np.int32),
                         seam=Seam(s=s0, slit_lo=lo))


class LatticeHierarchy(NamedTuple):
    """Static per-epoch data for the lattice GMG solve (device)."""

    grid: tuple             # finest vertex extents
    n_levels: int           # total levels incl. finest
    vert_pos: torch.Tensor  # (n_v,) int64
    dir_u: tuple            # per-level Dirichlet masks (dim, *g),
    #                         coarsest..finest
    dir_p: tuple            # per-level (1, *g)
    P_embed: torch.Tensor   # (nvc+1, ndl, ndl) f32
    seam: Seam | None = None   # the finest level's seam (slit lattices)
    slabs: tuple = ()       # per-level `Slab` of this process,
    #                         coarsest..finest
    n_split: int = 0        # the finest levels split by slab; the masks
    #                         of those hold this process's rows


def build_lattice_hierarchy(mesh, lay: LatticeLayout, dirichlet_fn, *,
                            device, min_coarse: int = 50, shard_mesh=None):
    """Host construction.  Levels halve the cell extents while the grid
    (and a slit lattice's seam) stays 2:1 coarsenable and the coarse
    vertex count stays at least `min_coarse`.  Each level gets its
    `Slab` (all its rows in one process) and, on a `shard_mesh` (the
    lattice layout's, or the ranks' of the replicated Newton), the
    finest levels are split by slab (`level_slabs`, seam-aware on a slit
    lattice)."""
    dim = mesh.dim
    grid = lay.grid
    seam = lay.seam
    grids, seams = [grid], [seam]
    while _seam_can_coarsen(grids[-1], seams[-1]):
        g_c = _seam_coarse_grid(grids[-1], seams[-1])
        if int(np.prod(g_c)) < min_coarse:
            break
        grids.append(g_c)
        seams.append(seam_coarse(seams[-1]))
    if len(grids) < 2:
        return None

    mask_u, mask_p = dirichlet_fn(mesh)
    mask_u = np.asarray(mask_u).reshape(mesh.n_vertices, dim)
    mask_p = np.asarray(mask_p)
    # a coarse-lattice node IS a fine node, so the geometric Dirichlet
    # masks inject exactly (per slab across a seam).  The mirror slots
    # carry no DoF: pinned on every level, so the free masks keep
    # canonical vectors zero there
    MU = np.zeros(grid + (dim,), bool)
    MP = np.zeros(grid, bool)
    pos_nd = np.unravel_index(lay.vert_pos, grid)
    MU[pos_nd] = mask_u
    MP[pos_nd] = mask_p
    du = np.moveaxis(MU, -1, 0)                    # (dim, *grid)
    dp = MP[None]                                  # (1, *grid)
    if seam is not None:
        du[:, seam.s + 1, :seam.slit_lo] = True
        dp[:, seam.s + 1, :seam.slit_lo] = True
    b = dict(dtype=torch.bool, device=device)
    dir_u = [torch.as_tensor(np.ascontiguousarray(du), **b)]
    dir_p = [torch.as_tensor(np.ascontiguousarray(dp), **b)]
    for sm in seams[:-1]:
        du = _seam_inject_down(du, sm)
        dp = _seam_inject_down(dp, sm)
        dir_u.insert(0, torch.as_tensor(np.ascontiguousarray(du), **b))
        dir_p.insert(0, torch.as_tensor(np.ascontiguousarray(dp), **b))
    slabs, n_split = level_slabs(shard_mesh, grid[0], len(grids),
                                 _seam_row(seam))
    slabs = slabs[::-1]
    L = len(grids)
    for l in range(L - n_split, L):
        dir_u[l] = slabs[l].rows(dir_u[l]).clone()
        dir_p[l] = slabs[l].rows(dir_p[l]).clone()
    i64 = dict(dtype=torch.int64, device=device)
    return LatticeHierarchy(
        grid=grid, n_levels=len(grids),
        vert_pos=torch.as_tensor(lay.vert_pos.astype(np.int64), **i64),
        dir_u=tuple(dir_u), dir_p=tuple(dir_p),
        P_embed=torch.as_tensor(embedding_matrices(dim),
                                dtype=torch.float32, device=device),
        seam=seam, slabs=tuple(slabs), n_split=n_split)


# ---------------------------------------------------------------------------
# lattice primitives
# ---------------------------------------------------------------------------

def gather_windows(X):
    """(k, *G) vertex lattice -> per-corner cell windows
    (nvc, k, *cellgrid)."""
    G = X.shape[1:]
    return torch.stack([X[_win(o, G)] for o in _offsets(len(G))])


def scatter_windows(Ye, grid):
    """(nvc, k, *cellgrid) per-corner cell values -> vertex lattice
    (k, *grid) by shifted window adds."""
    Y = torch.zeros((Ye.shape[1],) + tuple(grid), dtype=Ye.dtype,
                    device=Ye.device)
    for a, o in enumerate(_offsets(len(grid))):
        Y[_win(o, grid)] += Ye[a]
    return Y


def _cell_windows(U, P, P_old, P_oold, dim):
    """Per-cell values of lattice-layout state by window gathers:
    (u_e (nvc, dim, n_c), phi_e, pf_old_e, pf_oold_e (nvc, n_c))."""
    nvc = 2 ** dim
    n_c = int(np.prod([g - 1 for g in U.shape[1:]]))
    return (gather_windows(U).reshape(nvc, dim, n_c),
            *(gather_windows(X).reshape(nvc, n_c)
              for X in (P, P_old, P_oold)))


# Cell rows per batched contraction of the element residual, the element
# matrices and the Galerkin coarsening: every call sees the same number
# of cell rows at the same places, the whole level's pieces, so that a
# cell's bits do not depend on which cells the caller holds (on the card
# a batched product picks its kernel, and with it the order of its terms,
# from its shape: a slab's cells and the whole lattice's differed in
# their last bits, scripts/slab_bits.py; and a large one's terms may
# depend on a cell's place in it: the residual of a rank's rows of the
# refine-8 seam lattice differed, scripts/seam_bits.py).  A piece holds
# at most CELL_CHUNK cells (at least one row), RESIDUAL_CHUNK for the
# residual, and a whole level splits into pieces of equal rows, the rows
# a caller lacks filled with copies of its first or last row.  The
# element matrices' vmapped jvp takes 2**19 // piece tangents per pass
# and recomputes the residual once per pass, so their pieces are small;
# the residual has no tangents, and a larger piece takes fewer launches.
CELL_CHUNK = 1 << 16
RESIDUAL_CHUNK = 1 << 18


def _by_cell_rows(fn, arrays, cell_rows: int, ax: int, chunk: int,
                  first: int = 0):
    """fn over pieces of the cells of `arrays`, whose cell-row axis is
    `ax` (negative, the same for all) with the other cell axes after
    it, and whose first cell row is the whole level's row `first`.  A
    piece is a number of cell rows set by `cell_rows`, the whole level's,
    and `chunk`, from a multiple of that number on, and the cells of a
    row, flattened: fn takes and returns tensors with one cell axis,
    last.  Returns fn's outputs with their cell axis whole (flat)."""
    n = arrays[0].shape[ax]
    rc = math.prod(arrays[0].shape[ax:][1:])
    pieces = -(-cell_rows // max(1, chunk // rc))
    rows = -(-cell_rows // pieces)
    out = None
    for start in range(first - first % rows, first + n, rows):
        r0, r1 = max(start, first) - first, min(start + rows, first + n) - first
        idx = torch.arange(start - first, start - first + rows,
                           device=arrays[0].device).clamp(0, n - 1)
        res = fn(*(x.index_select(ax, idx).flatten(ax) for x in arrays))
        if out is None:
            out = [y.new_empty(y.shape[:-1] + (n * rc,)) for y in res]
        at = first + r0 - start
        for o, y in zip(out, res):
            o[..., r0 * rc:r1 * rc] = y[..., at * rc:(at + r1 - r0) * rc]
    return out


# the CellArrays fields with a cell axis that the element residual reads
_CA_CELL = ("JxW", "grads", "lam", "mu", "inv_diam2")


def _by_cells(fn, U, P, P_old, P_oold, caL, dim, rows, chunk, first=0):
    """fn(u_e, phi_e, pf_old_e, pf_oold_e, ca) of lattice-layout state
    and the raster-ordered CellArrays of its cells, in the pieces of
    `_by_cell_rows`; `rows` is the whole level's vertex rows (U's own
    if None), `first` the level's index of U's first row."""
    cgrid = tuple(g - 1 for g in U.shape[1:])
    split = lambda x: x.unflatten(-1, (cgrid[0], -1))
    vals = [split(x) for x in _cell_windows(U, P, P_old, P_oold, dim)]
    vals += [split(getattr(caL, f)) for f in _CA_CELL]

    def piece(*xs):
        ca = caL._replace(**dict(zip(_CA_CELL, xs[4:])))
        out = fn(*xs[:4], ca)
        return out if isinstance(out, tuple) else (out,)

    return _by_cell_rows(piece, vals, (rows or U.shape[1]) - 1, -2, chunk,
                         first)


def lattice_residual(U, P, P_old, P_oold, caL, sc, *, dim, with_split,
                     monolithic, rows: int | None = None, first: int = 0):
    """Gather-free residual assembly in lattice layout (port of the JAX
    ``lattice_residual``): U (dim, *grid), the phase fields (1, *grid),
    caL the raster-ordered CellArrays.  Returns the rhs (negative
    residual) (RU (dim, *grid), RP (1, *grid)), the physics of
    physics.assemble_residual with the cell gather and the vertex
    scatter-add as 2**dim shifted window slices.  Where U is some of a
    level's rows, `rows` is the level's and `first` the level's index of
    U's first row (the contractions' pieces, `_by_cell_rows`)."""
    nvc = 2 ** dim
    grid = tuple(U.shape[1:])
    cgrid = tuple(g - 1 for g in grid)
    ru_e, rp_e = _by_cells(
        lambda *v: physics._element_residual_cl(
            *v, sc, dim=dim, with_split=with_split, monolithic=monolithic),
        U, P, P_old, P_oold, caL, dim, rows, RESIDUAL_CHUNK, first)
    return (scatter_windows(ru_e.reshape((nvc, dim) + cgrid), grid),
            scatter_windows(rp_e.reshape((nvc, 1) + cgrid), grid))


def element_matrices_lattice(U, P, P_old, P_oold, caL, sc, *, dim,
                             with_split, monolithic,
                             rows: int | None = None, first: int = 0):
    """(ndl, ndl, *cellgrid) element Jacobians from lattice-layout state
    (window gathers instead of the flat gather maps); `rows`, `first`:
    see `lattice_residual`."""
    ndl = 2 ** dim * (dim + 1)
    cgrid = tuple(g - 1 for g in U.shape[1:])
    (jac,) = _by_cells(
        lambda *v: physics.element_matrices_from_cellvals(
            *v, sc, dim=dim, with_split=with_split, monolithic=monolithic),
        U, P, P_old, P_oold, caL, dim, rows, CELL_CHUNK, first)
    return jac.reshape((ndl, ndl) + cgrid)


def matvec_block(jacL, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Rectangular lattice block matvec: rows [lo_r, hi_r), columns
    [lo_c, hi_c) of the local element matrices.
    jacL (ndl, ndl, *cellgrid); X (k_in, *grid) -> (k_out, *grid)."""
    return stencil_matvec(jacL, X.contiguous(), lo_r, hi_r, lo_c, hi_c,
                          k_in, k_out)


def matvec(jacL, X, lo, hi, k):
    """Unmasked lattice matvec of one (square) block."""
    return matvec_block(jacL, X, lo, hi, lo, hi, k, k)


def block_diag(jacL, lo, hi, k, grid):
    """Lattice diagonal of one block: (k, *grid)."""
    idx = torch.arange(lo, hi, device=jacL.device)
    d = jacL[idx, idx]                            # (b, *cg)
    nvc = (hi - lo) // k
    return scatter_windows(d.reshape((nvc, k) + d.shape[1:]), grid)


def _ext_grid(jacL):
    """The vertex grid of a (ndl, ndl, *cellgrid) element array."""
    return tuple(c + 1 for c in jacL.shape[2:])


def gershgorin(jacL, free, Dinv, lo, hi, k, grid, seam: Seam | None = None,
               sl: Slab | None = None):
    """Upper bound on lambda_max(D^-1 A) via element-wise over-counted
    Gershgorin row sums.  Across a seam the glued rows' sums add: the
    row sums of S^T |A| S, still a bound on the conjugated operator's.
    Each row sum adds its terms in order, the same bits on any number of
    cells.  With a slab `sl`, jacL holds the process's cells and free /
    Dinv its rows; the maximum is over all processes."""
    blk = jacL[lo:hi, lo:hi].abs()
    rs = blk[:, 0]
    for j in range(1, blk.shape[1]):
        rs = rs + blk[:, j]                        # (b, *cg)
    nvc = (hi - lo) // k
    if sl is not None:
        grid = _ext_grid(jacL)
    s = scatter_windows(rs.reshape((nvc, k) + rs.shape[1:]), grid)
    if sl is None:
        s = seam_collect(s, seam)
        return torch.where(free, s * Dinv.abs(), 0.0).max()
    s = seam_collect(sl.owned(s), seam, sl)
    return sl.amax(torch.where(free, s * Dinv.abs(), 0.0).amax())


def lanczos_lambda(jacL, free, Dinv, lo, hi, k, grid, m: int = 10,
                   seam: Seam | None = None, sl: Slab | None = None):
    """Sharp lambda_max(D^-1 A) estimate on the free subspace: m-step
    Lanczos on the symmetrized S = D^(-1/2) (J + J^T)/2 D^(-1/2), top
    Ritz value, starting from a checkerboard +-1 on the free set.  The
    Gershgorin bound overestimates the Jacobi-scaled blocks ~1.5-2.3x
    and power iteration sits far below the clustered top of the phase-
    field block; see the JAX function for the measurements.  Falls back
    to the Gershgorin bound when the Ritz value is not finite and
    positive.  With a slab `sl` the vectors are the process's rows, each
    product takes one halo exchange and each dot is a `Slab.dots`."""
    dtype = Dinv.dtype
    sq = Dinv.abs().sqrt()
    # the transposed block, contiguous, once per level build
    jacT = jacL[lo:hi, lo:hi].transpose(0, 1).contiguous()
    nb = hi - lo
    dot = _dot if sl is None else (lambda a, b: sl.dots((a, b))[0])

    def S(x):
        (xs,) = seam_ext(sl, seam, torch.where(free, sq * x, 0.0))
        y = 0.5 * (matvec(jacL, xs, lo, hi, k) + matvec(jacT, xs, 0, nb, k))
        if sl is not None:
            y = sl.owned(y)
        return torch.where(free, sq * seam_collect(y, seam, sl), 0.0)

    ranges = [torch.arange(g, device=free.device) for g in grid]
    if sl is not None:
        ranges[0] = torch.arange(sl.a, sl.b, device=free.device)
    idx = sum(torch.meshgrid(*ranges, indexing="ij"))
    sign = torch.where(idx % 2 == 0, 1.0, -1.0).to(dtype)
    v = torch.where(free, sign[None], 0.0)
    n0 = torch.sqrt(dot(v, v))
    v = torch.where(n0 > 0, v / n0.clamp_min(1e-30), v)

    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(m):
        w = S(v) - beta * v_prev
        alpha = dot(v, w)
        w = w - alpha * v
        beta_new = torch.sqrt(dot(w, w))
        v_new = torch.where(beta_new > 0, w / beta_new.clamp_min(1e-30), w)
        alphas.append(alpha)
        betas.append(beta_new)
        v_prev, v, beta = v, v_new, beta_new
    a = torch.stack(alphas).cpu().float()
    b = torch.stack(betas).cpu().float()
    T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    lam = float(torch.linalg.eigvalsh(T).max())
    if math.isfinite(lam) and lam > 0:
        return torch.tensor(lam, dtype=dtype, device=Dinv.device)
    return gershgorin(jacL, free, Dinv, lo, hi, k, grid, seam, sl)


def coarsen(jacL, P_embed, cell_rows: int | None = None, first: int = 0):
    """Galerkin element-RAP one level down on the lattice:
    (ndl, ndl, *cg) -> (ndl, ndl, *(cg//2)).  Runs at full f32 (the
    package turns TF32 off): reduced-precision RAPs made the coarse
    operator indefinite in the JAX package (see cracks_tpu_torch's
    __init__).  Where jacL is some of a level's cells, `cell_rows` is
    the coarse level's cell rows and `first` the coarse level's index of
    its first coarse cell row (the contraction's pieces,
    `_by_cell_rows`)."""
    dim = jacL.dim() - 2
    # embedding_matrices orders child positions by geometric bits
    # (pos>>d)&1; _offsets(dim)[a] IS position a in that order
    As = [jacL[(slice(None), slice(None))
               + tuple(slice(oj, None, 2) for oj in o)]
          for o in _offsets(dim)]
    cells = As[0].shape[2:]
    P = P_embed.to(jacL.dtype)

    def rap(*As):
        out = 0.0
        for pos, A in enumerate(As):
            out = out + torch.einsum("ai,abc,bj->ijc", P[pos], A, P[pos])
        return (out,)

    (out,) = _by_cell_rows(rap, As, cell_rows or cells[0], 2 - jacL.dim(),
                           CELL_CHUNK, first)
    return out.unflatten(2, cells)


def coarsen_seam(jacL, P_embed, seam: Seam | None):
    """Galerkin element RAP one level down on a whole level (a seam
    lattice's too): `coarsen_slab` of one process's slabs of all rows."""
    grid = _ext_grid(jacL)
    return coarsen_slab(jacL, P_embed, whole(grid[0]),
                        whole(_seam_coarse_grid(grid, seam)[0]), seam)


def coarsen_chain(jacL, P_embed, n_levels: int, seam: Seam | None = None):
    """[coarsest..finest] Galerkin element-matrix levels."""
    jacs = [jacL]
    for sm in seam_levels(seam, n_levels)[:0:-1]:
        jacs.insert(0, coarsen_seam(jacs[0], P_embed, sm))
    return jacs


def _seam_row(seam: Seam | None):
    return None if seam is None else seam.s


def _coarsenable(fine_span, g, seam: Seam | None = None):
    """The coarse cell rows [p0, p1) that the fine cells held with the
    rows `fine_span` = (a, b) of a g-row level coarsen: all their
    children held.  A coarse cell's children are the fine cells from
    its lower vertex row's parent (`coarse_rows_below`) to the next
    one's: two, or on a seam the dead cell row s alone for the coarse
    dead row."""
    c0, c1 = _held(fine_span, g)
    s = _seam_row(seam)
    return coarse_rows_below(c0, s), coarse_rows_below(c1 + 1, s) - 1


def _held(span, g):
    """The cell rows [q0, q1) held with the rows `span` of a g-row level."""
    return max(span[0] - 1, 0), min(span[1], g - 1)


def _coarsen_cells(jac, c0, p0, p1, P_embed, cell_rows, seam):
    """`coarsen` into the coarse cell rows [p0, p1) from the fine cells
    `jac` held from cell row c0; across a seam the dead coarse row is
    zero and each slab's pairs of cell rows coarsen on their own (the
    dead fine row decouples them).  `cell_rows`: the whole coarse
    level's, or across a seam each slab's (the contraction's pieces)."""
    if seam is None:
        return coarsen(jac[:, :, 2 * p0 - c0:2 * p1 - c0], P_embed,
                       cell_rows, p0)
    sc = seam.s // 2
    parts = []
    if p0 < sc:
        f0 = 2 * p0 - c0
        parts.append(coarsen(jac[:, :, f0:f0 + 2 * (min(p1, sc) - p0)],
                             P_embed, sc, p0))
    if p0 <= sc < p1:
        parts.append(jac.new_zeros(jac.shape[:2] + (1, jac.shape[3] // 2)))
    if sc + 1 < p1:
        q0 = max(p0, sc + 1)
        f0 = 2 * q0 - 1 - c0
        parts.append(coarsen(jac[:, :, f0:f0 + 2 * (p1 - q0)], P_embed,
                             cell_rows - sc - 1, q0 - sc - 1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def coarsen_slab(jac, P_embed, fine: Slab, coarse: Slab,
                 seam: Seam | None = None):
    """`coarsen` of a process's cells of one level (those held with its
    rows, `Slab.cells`) into its cells of the next (`seam`: the fine
    level's, whose dead coarse row is zero): the coarse cells whose
    children it holds, and, where its coarse rows start or end one cell
    row past those, that row from the neighbour process that coarsens it
    (at most one row each way: a rank boundary at an odd fine row makes
    the lower process's last coarse cell the upper one's, at an even row
    the upper one's first coarse cell the lower one's; across a seam the
    upper slab's parity turns).  Every cell has one maker (the dead row
    is zero wherever it is made), so every holder has its bits.  On
    whole levels (`sharding.whole`) it is the Galerkin RAP of the
    level."""
    c0 = fine.cells[0]
    p0, p1 = _coarsenable((fine.a, fine.b), fine.g, seam)
    out = _coarsen_cells(jac, c0, p0, p1, P_embed, coarse.g - 1, seam)
    q0, q1 = coarse.cells
    m = fine.mesh
    if m is None or m.world == 1:
        return out
    r, gc = m.rank, coarse.g
    # what each neighbour lacks of its held cells and this process makes
    down = up = None
    if r > 0:
        pb = _coarsenable(fine.spans[r - 1], fine.g, seam)
        qb = _held(coarse.spans[r - 1], gc)
        if qb[1] > pb[1]:
            down = out[:, :, qb[1] - 1 - p0:qb[1] - p0]
    if r < m.world - 1:
        pa = _coarsenable(fine.spans[r + 1], fine.g, seam)
        qa = _held(coarse.spans[r + 1], gc)
        if qa[0] < pa[0]:
            up = out[:, :, qa[0] - p0:qa[0] + 1 - p0]
    assert q0 >= p0 - 1 and q1 <= p1 + 1, (q0, q1, p0, p1)
    if (q0, q1) == (p0, p1) and down is None and up is None:
        return out
    row = (out.shape[:2] + (1,) + out.shape[3:], out.dtype)
    below, above = dist.exchange_rows(
        m.ranks, down=down, up=up, from_below=row if q0 < p0 else None,
        from_above=row if q1 > p1 else None)
    return torch.cat([t for t in (below, out, above) if t is not None],
                     dim=2).contiguous()


def _owned_cells(jac, sl: Slab):
    """The cells of a process's held cells whose lower vertex row it
    owns: rows [a, min(b, g-1))."""
    a = sl.a - sl.cells[0]
    return jac[:, :, a:a + min(sl.b, sl.g - 1) - sl.a]


def gather_cells(jac, sl: Slab):
    """A whole level's cells from every process's held cells (one
    gather of the owned cell rows; the held cells themselves in one
    process)."""
    if sl.mesh is None or sl.mesh.world == 1:
        return jac
    cells = [(a, min(b, sl.g - 1)) for a, b in sl.spans]
    return gather_rows(_owned_cells(jac, sl).flatten(0, 1), sl.mesh,
                       cells).unflatten(0, jac.shape[:2]).contiguous()


def _axis_slice(ndim, axis, s):
    return tuple(s if j == axis else slice(None) for j in range(ndim))


def _prolong_axis(X, axis):
    """1d Q1 prolongation along one axis: n -> 2n-1 with midpoint
    averages."""
    n = X.shape[axis]
    shp = list(X.shape)
    shp[axis] = 2 * n - 1
    out = torch.zeros(shp, dtype=X.dtype, device=X.device)
    sl = lambda s: _axis_slice(X.dim(), axis, s)
    out[sl(slice(0, None, 2))] = X
    out[sl(slice(1, None, 2))] = 0.5 * (X[sl(slice(0, n - 1))]
                                        + X[sl(slice(1, n))])
    return out


def _restrict_axis(X, axis):
    """Transpose of _prolong_axis: 2n-1 -> n."""
    sl = lambda s: _axis_slice(X.dim(), axis, s)
    Xc = X[sl(slice(0, None, 2))].clone()
    mid = 0.5 * X[sl(slice(1, None, 2))]
    n = Xc.shape[axis]
    Xc[sl(slice(0, n - 1))] += mid
    Xc[sl(slice(1, n))] += mid
    return Xc


def prolong(Xc, grid, k):
    """Q1 2:1 lattice prolongation (k, *coarsegrid) -> (k, *grid),
    separable per axis."""
    X = Xc
    for j in range(len(grid)):
        X = _prolong_axis(X, j + 1)
    return X


def restrict(Xf, k):
    """Transpose of prolong: (k, *grid) -> (k, *coarsegrid)."""
    X = Xf
    for j in reversed(range(X.dim() - 1)):
        X = _restrict_axis(X, j + 1)
    return X


def prolong_seam(Xc, grid, k, seam: Seam | None):
    """prolong on a seam lattice: spread the canonical coarse field
    across its seam, Q1-prolong each slab on its own along the slit
    axis (the dead row decouples them) and across, then make the result
    canonical again.  On canonical vectors the adjoint of
    restrict_seam.  `prolong_slab` of whole levels."""
    if seam is None:
        return prolong(Xc, grid, k)
    return prolong_slab(Xc, whole(grid[0]), whole(Xc.shape[1]), seam=seam)


def restrict_seam(Xf, k, seam: Seam | None):
    """Transpose of prolong_seam: the per-slab Q1 restriction, then the
    coarse seam's collect (S_c^T P^T on canonical vectors).
    `restrict_slab` of whole levels."""
    if seam is None:
        return restrict(Xf, k)
    g = Xf.shape[1]
    return restrict_slab(Xf, whole(g), whole((g - 2) // 2 + 2), seam)


def _lips(seam: Seam | None, g: int):
    """The slabs a level of g rows coarsens in on its own, each as (its
    first fine row, its end, its first coarse row, its end): the whole
    level, or across a seam the lower lip's rows [0, s+1) and the upper
    lip's [s+1, g), the dead cell row between them."""
    if seam is None:
        return [(0, g, 0, (g - 1) // 2 + 1)]
    s = seam.s
    return [(0, s + 1, 0, s // 2 + 1), (s + 1, g, s // 2 + 1, (g - 2) // 2 + 2)]


def restrict_slab(Xf, fine: Slab, coarse: Slab, seam: Seam | None = None,
                  collect: bool = True):
    """`restrict` of a process's rows of a fine level to its rows of the
    coarse one, with the fine halo rows of one exchange: the axes past
    the leading one first, then the leading axis with `_restrict_axis`'s
    adds in its order (the parent row, + half the next odd row, + half
    the previous odd row), so each coarse value has the global one's
    bits.  Across a seam (`seam`, the fine level's) each lip restricts
    on its own and the coarse seam's collect follows (`restrict_seam`):
    canonical in, canonical out; without `collect` the caller collects
    (after the gather of a whole coarse level, which then needs no
    exchange of its own)."""
    (E,) = fine.ext(Xf)
    for j in reversed(range(2, E.dim())):
        E = _restrict_axis(E, j)
    e0 = fine.e0
    parts = []
    for L0, L1, C0, C1 in _lips(seam, fine.g):
        ca, cb = max(coarse.a, C0), min(coarse.b, C1)
        m = cb - ca
        if m <= 0:
            continue
        p = L0 + 2 * (ca - C0) - e0            # the first parent row in E
        Xc = E[:, p:p + 2 * m - 1:2].clone()
        n_next = min(cb, C1 - 1) - ca
        if n_next > 0:
            Xc[:, :n_next] += 0.5 * E[:, p + 1::2][:, :n_next]
        s = 1 if ca == C0 else 0
        if m > s:
            Xc[:, s:] += 0.5 * E[:, p + 2 * s - 1::2][:, :m - s]
        parts.append(Xc)
    Xc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return seam_collect(Xc, seam_coarse(seam), coarse) if collect else Xc


def prolong_slab(Xc, fine: Slab, coarse: Slab, whole: bool = False,
                 seam: Seam | None = None):
    """`prolong` of a process's rows of a coarse level (or, `whole`, of
    the whole coarse level) to its rows of the fine one, from the coarse
    halo rows of one exchange: the leading axis first, as `prolong`.
    Across a seam (`seam`, the fine level's) the coarse field is spread
    (`seam_ext`), each lip prolongs on its own, and the fine mirror slots
    are zeroed (`prolong_seam`)."""
    sc = seam_coarse(seam)
    if whole:
        C = seam_spread(Xc, sc)[:, coarse.e0:coarse.e1]
    else:
        (C,) = seam_ext(coarse, sc, Xc)
    parts = []
    for L0, L1, C0, _ in _lips(seam, fine.g):
        f0, f1 = max(fine.a, L0), min(fine.b, L1)
        if f0 >= f1:
            continue
        # the lip's coarse rows [C0 + k0, C0 + k1) reach its fine rows
        # [f0, f1)
        k0, k1 = (f0 - L0) // 2, (f1 - L0) // 2 + 1
        X = _prolong_axis(C[:, C0 + k0 - coarse.e0:C0 + k1 - coarse.e0], 1)
        parts.append(X[:, f0 - L0 - 2 * k0:f1 - L0 - 2 * k0])
    X = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    for j in range(2, X.dim()):
        X = _prolong_axis(X, j)
    if seam is not None and fine.a <= seam.s + 1 < fine.b:
        X[:, seam.s + 1 - fine.a, :seam.slit_lo] = 0.0
    return X


def inject_slab(A, fine: Slab, coarse: Slab, seam: Seam | None = None):
    """The injection of a process's rows of a fine level into its rows
    of the coarse one: the coarse row i is its parent, the fine row 2i,
    or across a seam (`seam`, the fine level's) the upper lip's rows
    from s+1 (`_seam_inject_down`)."""
    parts = []
    for L0, _, C0, C1 in _lips(seam, fine.g):
        ca, cb = max(coarse.a, C0), min(coarse.b, C1)
        if ca < cb:
            p = L0 + 2 * (ca - C0) - fine.a
            parts.append(A[:, p:p + 2 * (cb - ca) - 1:2])
    X = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return X[(slice(None), slice(None))
             + (slice(None, None, 2),) * (A.dim() - 2)]


# ---------------------------------------------------------------------------
# multigrid
# ---------------------------------------------------------------------------

class _LOps(NamedTuple):
    jac: torch.Tensor
    free: torch.Tensor
    Dinv: torch.Tensor
    lam: torch.Tensor
    rng: torch.Tensor   # Chebyshev smoothing range paired with lam


def _build_block_levels(jacs, dir_u, dir_p, grid, active_L, lo, hi, k,
                        which, sharp: bool = False, seam: Seam | None = None,
                        slabs=(), n_split: int = 0):
    """Per-level _LOps (coarsest..finest) for one block.  `sharp`
    selects the spectral window: Lanczos lambda_max + range 4 at
    production sizes, Gershgorin + range 20 at golden sizes.  The last
    `n_split` levels are split by slab (`slabs`, coarsest..finest): their
    jacs are the process's held cells, the masks and active_L its rows;
    the active set reaches the first whole level in one gather.  With
    slabs the whole levels' dots are `Slab.dots` too."""
    rng = torch.tensor(smoothing_range(sharp), dtype=jacs[0].dtype,
                       device=jacs[0].device)
    L = len(jacs)
    n_whole = L - n_split
    seams = seam_levels(seam, L)
    acts = [None] * L
    if which == "p":
        a = active_L
        for l in range(L - 1, -1, -1):
            acts[l] = a
            if l >= n_whole:
                a = inject_slab(a, slabs[l], slabs[l - 1], seams[l])
                if l - 1 < n_whole:
                    a = slabs[l - 1].gather(a)
            elif l:
                a = _seam_inject_down(a, seams[l])
    out = []
    for l in range(L):
        jac = jacs[l]
        sl = (slabs[l] if l >= n_whole else whole(jac.shape[2] + 1)
              if slabs else None)
        g = _ext_grid(jac)
        rows = g if sl is None else (sl.n,) + g[1:]
        if which == "p":
            free = ~(dir_p[l] | acts[l])
        else:
            free = torch.broadcast_to(~dir_u[l], (k,) + rows)
        free = free.contiguous()
        d = block_diag(jac, lo, hi, k, g)
        d = seam_collect(d if sl is None else sl.owned(d), seams[l], sl)
        Dinv = torch.where(free & (d.abs() > 0), 1.0 / d, 1.0)
        if sharp:
            lam = lanczos_lambda(jac, free, Dinv, lo, hi, k, rows,
                                 seam=seams[l], sl=sl)
        else:
            lam = gershgorin(jac, free, Dinv, lo, hi, k, g, seams[l], sl)
        out.append(_LOps(jac=jac, free=free, Dinv=Dinv, lam=lam, rng=rng))
    return out


def _masked_mv(lv: _LOps, lo, hi, k, seam: Seam | None = None,
               sl: Slab | None = None):
    """The level's masked product; with a slab `sl` on the process's
    rows, its halo rows from one exchange."""
    def op(X):
        (X,) = seam_ext(sl, seam, torch.where(lv.free, X, 0.0))
        Y = matvec(lv.jac, X, lo, hi, k)
        if sl is not None:
            Y = sl.owned(Y)
        return torch.where(lv.free, seam_collect(Y, seam, sl), 0.0)
    return op


def _sharded_op(lv: _LOps, fine_pad, k, mesh, seam: Seam | None = None,
                sl: Slab | None = None):
    """The finest level's masked product on the sharded kernel
    (`stencil_matvec_sharded`, one launch for this process's shards),
    collect . product . spread on a seam lattice.  Where the seam
    straddles a rank boundary the halo rows are exchanged here and
    spread before the launch: the owner of row s+1 takes row s's glued
    columns from its lower halo row, the owner of s writes its own into
    its upper halo row."""
    def op(X):
        X = seam_spread(torch.where(lv.free, X, 0.0), seam,
                        0 if sl is None else sl.a)
        halo = None
        if _straddles(seam, sl):
            below, above = halo_rows(X, mesh)
            s, lo = seam
            if sl.a == s + 1:
                X = X.clone()
                X[:, 0, :lo] = below[:, 0, :lo]
            else:
                above = above.clone()
                above[:, 0, :lo] = X[:, -1, :lo]
            halo = (below, above)
        Y = stencil_matvec_sharded(fine_pad, X, k, mesh, halo=halo)
        return torch.where(lv.free, seam_collect(Y, seam, sl), 0.0)
    return op


def _coarse_dense_factor(lv0: _LOps, lo, hi, k, seam0: Seam | None = None):
    """Dense Cholesky of the coarsest-level block, Jacobi-scaled, in
    f64.  Returns (lower factor L, scale s) with
    s A s + 1e-5 I = L L^T on the free dofs (identity elsewhere).  With
    a seam the mirror slots alias their canonical slot in the scatter
    index, so the assembly gives S^T A S directly; the mirror slots,
    left without entries, are pinned to the identity like every other
    slot that is not free."""
    g0 = tuple(lv0.free.shape[1:])
    nvert0 = int(np.prod(g0))
    n0 = k * nvert0
    dev = lv0.jac.device
    pos = torch.arange(nvert0, device=dev).reshape(g0)
    if seam0 is not None:
        pos[seam0.s + 1, :seam0.slit_lo] = pos[seam0.s, :seam0.slit_lo]
    offs = _offsets(len(g0))
    wins = torch.stack([pos[tuple(slice(o[j], g0[j] - 1 + o[j])
                                  for j in range(len(g0)))]
                        for o in offs])            # (nvc, *cg0)
    # local dof ldof = a*k + d  ->  flat = d*nvert0 + win[a]
    comp = torch.arange(k, device=dev)
    lflat = (comp[None, :, None] * nvert0
             + wins.reshape(len(offs), 1, -1))     # (nvc, k, n_cells0)
    b = hi - lo
    lflat = lflat.reshape(b, -1)                   # (b, n_cells0)
    A = lv0.jac[lo:hi, lo:hi].reshape(b, b, -1).to(torch.float64)
    rows = lflat[:, None, :].expand(b, b, lflat.shape[1])
    cols = lflat[None, :, :].expand(b, b, lflat.shape[1])
    A0 = torch.zeros((n0, n0), dtype=torch.float64, device=dev)
    A0.index_put_((rows.reshape(-1), cols.reshape(-1)), A.reshape(-1),
                  accumulate=True)
    m = lv0.free.reshape(-1)
    A0 = torch.where(m[:, None] & m[None, :], A0, 0.0)
    A0 = A0 + torch.diag(torch.where(m, 0.0, 1.0).to(torch.float64))
    s = 1.0 / torch.sqrt(torch.diagonal(A0).abs())
    A0s = A0 * s[:, None] * s[None, :]
    # SPD-safety shift (preconditioner only; the refinement passes
    # correct any inexactness): the element chain feeding A0 is f32, so
    # its rounding can leave lambda_min slightly negative
    A0s = A0s + 1e-5 * torch.eye(n0, dtype=torch.float64, device=dev)
    return torch.linalg.cholesky(A0s), s


def make_vcycle(levels, lo, hi, k, coarse_factor, degree: int = 2,
                fine_op=None, seam: Seam | None = None, slabs=(),
                n_split: int = 0):
    """V-cycle with Chebyshev pre/post smoothing on every level above
    the coarsest and the dense Cholesky solve (in the factor's dtype)
    on the coarsest.  `fine_op`, when given, is the finest level's
    masked operator (the sharded product); `seam` is the finest
    level's.  The last `n_split` levels work on the process's rows
    (`slabs`, coarsest..finest): their transfers exchange one halo row,
    and the residual restricted to the first whole level is gathered."""
    L = len(levels)
    n_whole = L - n_split
    seams = seam_levels(seam, L)
    cho, cho_scale = coarse_factor
    shape0 = levels[0].free.shape

    def cycle(l, b):
        lv = levels[l]
        b = torch.where(lv.free, b, 0.0)
        if l == 0:
            bs = (cho_scale * b.reshape(-1).to(cho.dtype))[:, None]
            x = cho_scale * torch.cholesky_solve(bs, cho, upper=False)[:, 0]
            return torch.where(lv.free, x.to(b.dtype).reshape(shape0), 0.0)
        sl = slabs[l] if l >= n_whole else None
        op = (fine_op if fine_op is not None and l == L - 1
              else _masked_mv(lv, lo, hi, k, seams[l], sl))
        x = _chebyshev(op, lv.Dinv, b, lv.lam, degree, lv.rng)
        r = b - op(x)
        if sl is None:
            e_c = cycle(l - 1, restrict_seam(r, k, seams[l]))
            g = tuple(lv.free.shape[1:])
            p = prolong_seam(e_c, g, k, seams[l])
        else:
            top = l - 1 < n_whole
            # a whole coarse level collects its seam after the gather
            r_c = restrict_slab(r, sl, slabs[l - 1], seams[l], not top)
            if top:
                r_c = seam_collect(slabs[l - 1].gather(r_c), seams[l - 1])
            e_c = cycle(l - 1, r_c)
            p = prolong_slab(e_c, sl, slabs[l - 1], top, seams[l])
        x = x + torch.where(lv.free, p, 0.0)
        r = b - op(x)
        return x + _chebyshev(op, lv.Dinv, r, lv.lam, degree, lv.rng)

    return lambda b: cycle(L - 1, b)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def _blk(which, dim):
    """(k, lo, hi) of one block in the corner-major local dof order."""
    nvc = 2 ** dim
    if which == "u":
        return dim, 0, nvc * dim
    return 1, nvc * dim, nvc * (dim + 1)


def _active_lattice(active, vert_pos, grid):
    nvert = int(np.prod(grid))
    return torch.zeros(nvert, dtype=torch.bool, device=active.device
                       ).index_put((vert_pos,), active).reshape(
                           (1,) + tuple(grid))


def _to_lat(xg, vert_pos, grid, k):
    """Flat global dof vector -> (k, *grid) lattice layout."""
    nvert = int(np.prod(grid))
    X = torch.zeros((nvert, k), dtype=xg.dtype, device=xg.device)
    X[vert_pos] = xg.reshape(-1, k)
    return X.reshape(tuple(grid) + (k,)).movedim(-1, 0).contiguous()


def _to_glob(X, vert_pos, k):
    """(k, *grid) lattice layout -> flat global dof vector."""
    return X.movedim(0, -1).reshape(-1, k)[vert_pos].reshape(-1)


def _prepare64(U, P, P_old, P_oold, caL64, sc, *, grid, dim, with_split,
               monolithic, seam=None, sl: Slab | None = None):
    """Exact f64 element Jacobians (ndl, ndl, *cellgrid) from (padded)
    lattice-layout state, built once per Newton solve (JAX
    ``_prepare64_lat``; its ``_maybe_shard_jacs`` is a placement and has
    no counterpart on one device).  Canonical seam state is spread first,
    so the window gathers see the shared values on both lips.  With a
    slab `sl` the state is the process's rows and caL64 its held cells,
    whose matrices it returns (the halo rows of one exchange)."""
    n = grid[0] if sl is None else sl.n
    state = seam_ext(sl, seam, *(unpad_rows(X, n)
                                 for X in (U, P, P_old, P_oold)))
    return element_matrices_lattice(*state, caL64, sc, dim=dim,
                                    with_split=with_split,
                                    monolithic=monolithic,
                                    rows=grid[0] if sl is None else sl.g,
                                    first=0 if sl is None else sl.e0)


def _prepare32_from64(jacL64, P_embed, *, n_levels, seam=None, slabs=(),
                      n_split: int = 0):
    """The f32 operator chain is the CAST of the exact f64 element
    matrices, Galerkin-coarsened (branch-consistent with the f64
    operator; see the JAX function).  Also the port of
    ``_prepare32_from64_lat``.  Split by slab (`slabs`, coarsest..
    finest, the last `n_split` split), the split levels are the
    process's held cells (`coarsen_slab`) and the first whole level is
    gathered, then coarsened whole."""
    jac = jacL64.to(torch.float32)
    if not n_split:
        return tuple(coarsen_chain(jac, P_embed, n_levels, seam))
    L = n_levels
    seams = seam_levels(seam, L)
    split = [jac]
    for l in range(L - 1, L - n_split - 1, -1):
        split.insert(0, coarsen_slab(split[0], P_embed, slabs[l],
                                     slabs[l - 1], seams[l]))
    top = gather_cells(split.pop(0), slabs[L - n_split - 1])
    return tuple(coarsen_chain(top, P_embed, L - n_split,
                               seams[L - n_split - 1]) + split)


def _prepare_levels(jacs, dir_u, dir_p, active, *, grid, which, dim,
                    sharp, mesh=None, seam=None, slabs=(), n_split: int = 0):
    """Per-block level operators and the coarse factor from a (padded)
    lattice-layout active mask (1, gyp, ...), built once per Newton
    solve (JAX ``_prepare_levels_lat``).  The coarse Cholesky is
    factored in f64 and handed to the f32 CG pass as an f32 factor.
    With a shard mesh the finest f32 block is also laid out as the
    stacked per-shard carrier (`pad_jac_sharded`) for the sharded fine
    operator of `_cg_pass32`; fine_pad is None without one.  Split by
    slab, the active mask and the finest levels are the process's
    rows.  Returns (levels, coarse32, fine_pad)."""
    k, lo, hi = _blk(which, dim)
    n = slabs[-1].n if n_split else grid[0]
    levels = _build_block_levels(list(jacs), dir_u, dir_p, grid,
                                 unpad_rows(active, n), lo, hi, k,
                                 which, sharp=sharp, seam=seam, slabs=slabs,
                                 n_split=n_split)
    cho, scale = _coarse_dense_factor(levels[0], lo, hi, k,
                                      seam_levels(seam, len(levels))[0])
    if mesh is None:
        fine_pad = None
    elif n_split:
        fine_pad = pad_jac_sharded(_owned_cells(jacs[-1], slabs[-1]), lo, hi,
                                   lo, hi, mesh,
                                   rows_loc=mesh.rows_loc(grid[0]))
    else:
        fine_pad = pad_jac_sharded(jacs[-1], lo, hi, lo, hi, mesh)
    return levels, (cho.to(torch.float32), scale.to(torch.float32)), fine_pad


def _pass_setup(fin_free, R, rtol, target2, *, grid, sl: Slab | None = None):
    """f64 -> f32 boundary of one CG pass on a (padded) lattice-layout
    residual (JAX ``_pass_setup_lat``): residual norm, the normalized
    true-shaped f32 residual and the f32 pass tolerance.  With a slab
    `sl`, the process's rows and the norm of `Slab.dots`."""
    if sl is None:
        R = unpad_rows(R, grid[0])
        rr0 = _dot(R, R)
    else:
        R = unpad_rows(R, sl.n)
        rr0 = sl.dots((R, R))[0]
    scale = torch.sqrt(rr0)
    inv_scale = torch.where(scale > 0, 1.0 / scale, 0.0)
    R0 = torch.where(fin_free, (R * inv_scale).to(torch.float32), 0.0)
    # pass target 3e-7 relative on the NORMALIZED system: each f64
    # refinement restart costs a stored-matrix f64 operator application,
    # so the f32 pass digs as deep as single precision allows; the
    # stall window in _cg_pass32 exits early at the f32 floor
    tol2 = torch.where(rr0 > 0, target2 / rr0, 1.0).clamp_min(
        max(rtol, 3e-7) ** 2).to(torch.float32)
    return R0, scale, tol2, rr0


def _cg_pass32(levels, coarse32, R0, tol2, *, which, dim, fine_pad=None,
               mesh=None, seam=None, degree=2, inner_max=192,
               stall_window=16, slabs=(), n_split: int = 0):
    """One float32 lattice-GMG CG pass on the normalized lattice
    residual; returns (best iterate, inner iterations, best rr).

    Exits when the pass target is met, inner_max is reached, or no new
    best residual appeared within `stall_window` iterations (the f32
    arithmetic floor).  inner_max is 192 at every size: the JAX package
    lowers it to 96 above 600k DoFs only to bound one TPU execution's
    time.  With fine_pad (a shard mesh), the finest level's operator,
    the dominant product of both the CG loop and the V-cycle smoother,
    is the sharded product (`stencil_matvec_sharded`), as the JAX pass
    runs the Pallas kernel under ``shard_map`` (``lattice.py:1126-1149``).
    With a seam every product is spread -> product -> collect, the
    sharded one too (`_sharded_op`).  That is a deliberate divergence:
    JAX keeps seam lattices off its sharded kernel
    (``lattice.py:1975-1983``) only because its conjugation is a global
    matmul under GSPMD; here the conjugation wraps the sharded product
    on the process's rows.  The exit test reads one scalar per
    iteration back to the host; the next iteration's work is queued
    before that read, so the card stays busy while the host waits.
    Split by slab (`slabs`, `n_split`), R0 and the iterates are the
    process's rows, the sharded product takes its halo rows from the
    neighbour ranks, and each iteration's dots are two `Slab.dots`
    calls (p . Ap; r . r with r . z)."""
    k, lo, hi = _blk(which, dim)
    fin = levels[-1]
    sl = slabs[-1] if slabs else None
    if sl is None:
        def dots(*pairs, host=False):
            t = torch.stack([_dot(x, y) for x, y in pairs])
            return (t, t.cpu()) if host else t
    else:
        dots = sl.dots
    if fine_pad is None:
        op = _masked_mv(fin, lo, hi, k, seam, sl)
    else:
        op = _sharded_op(fin, fine_pad, k, mesh, seam, sl)
    M = make_vcycle(levels, lo, hi, k, coarse32, degree=degree, fine_op=op,
                    seam=seam, slabs=slabs, n_split=n_split)
    tol2_h = float(tol2)
    Z = M(R0)
    X = torch.zeros_like(R0)
    R, Pv, rz = R0, Z, dots((R0, Z))[0]
    Xb, rrb, kb, kk = torch.zeros_like(R0), 1.0, 0, 0
    while rrb > tol2_h and kk < inner_max and kk - kb < stall_window:
        Ap = op(Pv)
        denom = dots((Pv, Ap))[0]
        alpha = torch.where(denom != 0, rz / denom, 0.0)
        X = X + alpha * Pv
        R = R - alpha * Ap
        Z = M(R)
        tot, tot_h = dots((R, R), (R, Z), host=True)
        rz_new = tot[1]
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        Pv = Z + beta * Pv
        rz = rz_new
        kk += 1
        rr_h = float(tot_h[0])
        if rr_h < rrb:
            Xb, rrb, kb = X, rr_h, kk
    return Xb, kk, rrb


def _pass_apply_mat(Xb, scale, X_acc, B, jacL64, free_u, free_p, *, grid,
                    which, dim, gyp, seam=None, sl: Slab | None = None):
    """f32 -> f64 boundary of one CG pass in lattice layout (JAX
    ``_pass_apply_mat_lat``): un-normalize the true-shaped pass iterate,
    form the trial accumulate, apply the exact f64 Newton operator (the
    stored f64 element matrices, one unsharded product, as in JAX) and
    form the trial residual.  X_acc and B arrive padded.  Returns padded
    (X_try, R_try), rr_try and, for which == 'u', the padded
    JP = J_pu X_try (the phase-field block's right-hand side
    correction; None for 'p').  With a slab `sl` the products run on
    the process's halo'd rows (one exchange) and its held f64 cells, and
    rr_try is a `Slab.dots`."""
    k, lo, hi = _blk(which, dim)
    nvc = 2 ** dim
    g0 = grid[0] if sl is None else sl.n
    X_try = unpad_rows(X_acc, g0) + Xb.to(torch.float64) * scale
    free = free_u if which == "u" else free_p
    (Xs,) = seam_ext(sl, seam, torch.where(free, X_try, 0.0))
    own = (lambda Y: Y) if sl is None else sl.owned
    Ys = [own(matvec(jacL64, Xs, lo, hi, k))]
    if which == "u":
        Ys.append(own(matvec_block(jacL64, Xs, nvc * dim, nvc * (dim + 1),
                                   lo, hi, k, 1)))
    Ys = seam_collect_rows(Ys, seam, sl)
    R_try = unpad_rows(B, g0) - torch.where(free, Ys[0], 0.0)
    rr_try = _dot(R_try, R_try) if sl is None else sl.dots((R_try,
                                                             R_try))[0]
    JP = None
    if which == "u":
        JP = pad_rows(torch.where(free_p, Ys[1], 0.0), gyp)
    return pad_rows(X_try, gyp), pad_rows(R_try, gyp), rr_try, JP


def solve_lattice_lat(sys, U, P, P_old, P_oold, active, RHS_U, RHS_P,
                      with_split, *, passes: int = 3, degree: int = 2,
                      jac_rtol: float = 1e-6):
    """Block Gauss-Seidel solve of the Newton system on lattice-layout
    state (JAX ``_solve_split_lat``): the u block, then the phase-field
    block with the J_pu coupling moved to its right-hand side.  Each
    block runs up to `passes` restarted-refinement passes: f32
    GMG-preconditioned CG on the normalized residual, then the exact f64
    stored-matrix residual.  U (dim, gyp, ...), the phase fields, the
    active mask and the right-hand sides (k, gyp, ...), with zero pad
    rows past the lattice's G0 rows (gyp = G0 without a shard mesh).
    On a shard mesh (the hierarchy's slabs') the f32 fine-level operator
    is the sharded one.
    On a seam lattice every vector is canonical (`Seam`).  Split by slab
    (`hier.n_split`) the vectors are the process's rows, padded to its
    shards' rows.  Returns padded (DU, DP, total CG iterations) on the
    free dofs."""
    hier: LatticeHierarchy = sys.lattice_hierarchy
    p = sys.params
    rtol = p.cg_rtol
    eps64 = float(np.finfo(np.float64).eps)
    grid = hier.grid
    dim = sys.dim
    gyp = U.shape[1]
    mesh = hier.slabs[-1].mesh
    seam = hier.seam
    split = dict(slabs=hier.slabs, n_split=hier.n_split)
    sl = hier.slabs[-1] if hier.slabs else None
    n = grid[0] if sl is None else sl.n
    free_u = ~hier.dir_u[-1]
    free_p = ~(hier.dir_p[-1] | unpad_rows(active, n))

    # Operator reuse across the PDAS tail (solvers/opcache.py): the f32
    # chain and the stored f64 operator are reused while the context
    # moved by at most `jac_rtol` from the point where they were built.
    ctx = (U, P, P_old, P_oold, opcache.scalars_vec(sys.scalars))
    flags = (with_split, sys.monolithic)
    hit = opcache.lookup(sys._split_jac_cache, ctx, flags, jac_rtol,
                         None if sl is None else sl.amax)
    if hit is not None:
        jacs, jacL64 = hit
    else:
        # drop the stale operators before building replacements
        sys._split_jac_cache = None
        sys._split_levels_cache = None
        jacL64 = _prepare64(U, P, P_old, P_oold, sys.lattice_ca64,
                            sys.scalars, grid=grid, dim=dim,
                            with_split=with_split,
                            monolithic=sys.monolithic, seam=seam, sl=sl)
        jacs = _prepare32_from64(jacL64, hier.P_embed,
                                 n_levels=hier.n_levels, seam=seam, **split)
        sys._split_jac_cache = (ctx, flags, (jacs, jacL64))
    del hit
    total_its = 0
    last_ju_pu = None   # J_pu DU of the final accepted u iterate

    def block(which, B):
        nonlocal total_its, last_ju_pu
        # pad rows are zero
        bnorm = float(torch.sqrt(_dot(B, B) if sl is None else sl.dots(
            (unpad_rows(B, n), unpad_rows(B, n)))[0]))
        # absolute floor: the linear residual only has to be invisible
        # at the Newton iteration's own (absolute) convergence bound;
        # PDAS-tail right-hand sides are pure f64 assembly noise
        atol_newton = 1e-3 * p.lower_bound_newton_residual
        target2 = max(rtol * bnorm, atol_newton, 100.0 * eps64 * bnorm) ** 2
        if bnorm * bnorm <= target2:
            return torch.zeros_like(B)
        # u-block level operators depend only on the element Jacobians
        # and the Dirichlet masks, not on the active set, so they ride
        # the operator cache; the p block's mask changes every iteration
        lv_cache = sys._split_levels_cache
        if which == "u" and lv_cache is not None and lv_cache[0] is jacs:
            levels, coarse32, fine_pad = lv_cache[1]
        else:
            levels, coarse32, fine_pad = _prepare_levels(
                jacs, hier.dir_u, hier.dir_p, active, grid=grid,
                which=which, dim=dim, sharp=sharp_spectrum(sys.mesh.n_dofs),
                mesh=mesh, seam=seam, **split)
            if which == "u":
                sys._split_levels_cache = (jacs, (levels, coarse32,
                                                  fine_pad))
        fin_free = levels[-1].free
        target2_d = torch.tensor(target2, dtype=torch.float64,
                                 device=B.device)
        X_acc = torch.zeros_like(B)
        R_cur = B
        rr_cur = bnorm * bnorm
        for _ in range(passes):
            if rr_cur <= target2:
                break
            R0, scale, tol2, _rr0 = _pass_setup(fin_free, R_cur, rtol,
                                                target2_d, grid=grid, sl=sl)
            Xb, its, _rrb = _cg_pass32(levels, coarse32, R0, tol2,
                                       which=which, dim=dim,
                                       fine_pad=fine_pad, mesh=mesh,
                                       seam=seam, degree=degree, **split)
            X_try, R_try, rr_try_d, JP = _pass_apply_mat(
                Xb, scale, X_acc, B, jacL64, free_u, free_p, grid=grid,
                which=which, dim=dim, gyp=gyp, seam=seam, sl=sl)
            total_its += its
            rr_try = float(rr_try_d)
            if not np.isfinite(rr_try) or rr_try >= rr_cur:
                break
            progress = rr_try / max(rr_cur, 1e-300)
            X_acc, R_cur, rr_cur = X_try, R_try, rr_try
            if which == "u":
                last_ju_pu = JP
            if rr_cur <= target2 or progress > 0.25:
                break
        return X_acc

    DU = block("u", RHS_U)
    RHS_P2 = RHS_P if last_ju_pu is None else RHS_P - last_ju_pu
    DP = block("p", RHS_P2)
    return DU, DP, total_its


def local_rows(sys) -> int:
    """The rows of this process's padded lattice-layout vectors: its
    shards' on the hierarchy's shard mesh (all shards' in one process),
    the lattice's without one."""
    hier: LatticeHierarchy = sys.lattice_hierarchy
    mesh = hier.slabs[-1].mesh
    if mesh is None:
        return hier.grid[0]
    return mesh.n_local * mesh.rows_loc(hier.grid[0])


def rows_of(sys, x, k: int):
    """This process's rows (the finest level's slab) of the flat dof
    vector x with k components per vertex, in lattice layout (k, n,
    ...), unpadded."""
    hier: LatticeHierarchy = sys.lattice_hierarchy
    sl = hier.slabs[-1]
    return _to_lat(x, hier.vert_pos, hier.grid, k)[:, sl.a:sl.b]


def solve_lattice(sys, u, phi, phi_old, phi_oold, active, rhs_u, rhs_p,
                  with_split):
    """Flat-vector entry of the solve for the replicated Newton (JAX
    ``_solve_split``): lift the flat state, active mask and right-hand
    sides to the lattice layout, run `solve_lattice_lat`, map the
    updates back.  The solve takes the hierarchy's slabs, whole levels
    in one process, so its dots are the per-row sums of every lattice
    run.  On W ranks (the replicated cell-axis mode) each rank cuts its
    shards' rows out of the whole vectors, runs the slab-split solve on
    them and gets the whole updates back from one gather of rows; a
    lattice too small to give every rank a row is solved whole on every
    rank (the hierarchy's slabs say which).
    Returns (du, dp, total CG iterations)."""
    hier: LatticeHierarchy = sys.lattice_hierarchy
    vp, grid, dim = hier.vert_pos, hier.grid, sys.dim
    sl = hier.slabs[-1]
    gyp = local_rows(sys)
    lat = lambda x, k: pad_rows(rows_of(sys, x, k), gyp)
    act = pad_rows(_active_lattice(active, vp, grid)[:, sl.a:sl.b], gyp)
    DU, DP, its = solve_lattice_lat(
        sys, lat(u, dim), lat(phi, 1), lat(phi_old, 1), lat(phi_oold, 1),
        act, lat(rhs_u, dim), lat(rhs_p, 1), with_split)
    D = sl.gather(torch.cat([unpad_rows(DU, sl.n), unpad_rows(DP, sl.n)]))
    return _to_glob(D[:dim], vp, dim), _to_glob(D[dim:], vp, 1), its
