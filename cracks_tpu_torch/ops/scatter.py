"""Deterministic scatter-add (torch).

``torch.Tensor.index_add_`` is an atomic scatter on CUDA: the order in
which the duplicates of one target are summed changes from run to run,
and with it the last bits of the sum.  The residual assembly, the
hanging-node condensation, the dense matrix of the direct solve and the
stored-element-matrix Krylov operator sum through a `ScatterTable`
instead: the flat positions of each target's contributions, found once
by a stable sort of the index, added to the target's value one by one
in index order (the order of a sequential scatter such as the CPU's
``index_add_`` or XLA's CPU scatter, so the CPU's bits do not change),
then written with one ``index_put_`` of distinct targets.  The same
bits come out of every run on the card, and on W ranks of the
replicated cell-axis mode, which gather every rank's per-cell terms
before the scatter (`CellScatter.all_cells`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ScatterTable(NamedTuple):
    """Where each target's contributions lie in the flat value array."""

    targets: torch.Tensor  # (m,) int64 distinct target indices, ascending
    table: torch.Tensor    # (m, K) int64 flat positions; n_values pads


def scatter_table(index: torch.Tensor,
                  keep: torch.Tensor | None = None) -> ScatterTable:
    """The table of a scatter by `index` (any shape; flattened).  With
    `keep` (a bool tensor of index's shape) only the kept entries are
    summed: a prolongation stencil's zero-weight slots, which all name
    one padding master, stay out of its transpose's table."""
    idx = index.reshape(-1)
    n = idx.numel()
    pos = (torch.arange(n, device=idx.device) if keep is None
           else torch.nonzero(keep.reshape(-1)).squeeze(1))
    if pos.numel() == 0:
        return ScatterTable(idx[:0], idx.new_zeros((0, 0)))
    sub = idx[pos]
    order = torch.argsort(sub, stable=True)
    targets, counts = torch.unique_consecutive(sub[order],
                                               return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(
        torch.arange(targets.numel(), device=idx.device), counts)
    rank = torch.arange(sub.numel(), device=idx.device) - starts[seg]
    table = torch.full((targets.numel(), int(counts.max())), n,
                       dtype=torch.int64, device=idx.device)
    table[seg, rank] = pos[order]
    return ScatterTable(targets, table)


def scatter_add(st: ScatterTable, values: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """Add `values` (flattened like the table's index) into the flat
    tensor `out` in place, at each target in index order; returns
    `out`."""
    v = torch.cat([values.reshape(-1), values.new_zeros(1)])[st.table]
    acc = out[st.targets]
    for k in range(v.shape[1]):
        acc = acc + v[:, k]
    return out.index_put_((st.targets,), acc)


def scatter_add_rows(st: ScatterTable, values: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Add the rows of `values` (n, *row) into the rows of `out`
    (N, *row) in place, by a table of a 1-d index of length n, each
    target's rows in index order; returns `out`."""
    v = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    acc = out[st.targets]
    for k in range(st.table.shape[1]):
        acc = acc + v[st.table[:, k]]
    return out.index_put_((st.targets,), acc)


# The card's batched contractions pick their order of terms from the
# number of cells they see and a cell's terms from its place among them
# (`scripts/cell_range_bits.py`: a range of the cells of a mesh of 124
# or 932 cells gets other last bits than the whole mesh; the lattice's
# residual pieces, `solvers/lattice.py`: a cell at another place in a
# piece gets other last bits), and on W ranks of
# the replicated cell-axis mode each rank must compute its cells' terms
# with the one-process bits.  So with n_devices = D > 1 the per-cell
# functions work on the card in the mesh's pieces of `piece_size` cells
# (`in_pieces`): a process computes each piece that holds some of its
# cells, every cell at its place in it, the places of cells it does not
# hold filled with copies of its nearest cell.  A mesh of at most
# PIECE_MIN cells is one piece of all its cells, so that a one-process
# run computes as at once; a larger mesh is CELL_PIECES pieces of at
# least PIECE_MIN cells.  With D = 1 (no ranks) a call takes all its
# cells at once, and so does every call on the CPU, whose contractions
# keep a cell's bits at any count and place (the same script).
CELL_PIECES = 4
PIECE_MIN = 1 << 14
# tests set this to run the card's pieces on the CPU (whose bits they
# keep: the pieces change no value there)
PIECES_ON_CPU = False


def piece_size(n_cells: int, n_shards: int) -> int:
    """The card's cells per piece of a mesh of n_cells cells split over
    n_shards shards (0: no pieces)."""
    if n_shards == 1:
        return 0
    if n_cells <= PIECE_MIN:
        return n_cells
    return max(-(-n_cells // CELL_PIECES), PIECE_MIN)


def _n_cells(a, axis: int) -> int:
    return a.JxW.shape[-1] if hasattr(a, "map_cells") else a.shape[axis]


def in_pieces(fn, size: int, first: int, *arrays, axis: int = -1):
    """fn(*arrays) -> a tensor or a tuple of tensors, each with the
    cells on `axis` as in `arrays`: per-cell tensors with the cells on
    `axis`, or with axis -1 cell arrays (`physics.CellArrays`), the
    cells those of a mesh from its cell `first` on.  On the card, with a
    `size`, computed piece by piece of the mesh's pieces [k size,
    (k+1) size) that hold these cells, each cell at its place, the other
    places copies of the nearest of these cells, and concatenated; at
    once elsewhere."""
    a0 = arrays[0]
    n = _n_cells(a0, axis)
    dev = a0.JxW.device if hasattr(a0, "map_cells") else a0.device
    if (not size or (first == 0 and n == size)
            or not (dev.type == "cuda" or PIECES_ON_CPU)):
        return fn(*arrays)
    outs = []
    for k in range(first // size, -(-(first + n) // size)):
        at = k * size - first          # the piece's first place, here
        lo, hi = max(at, 0), min(at + size, n)
        if (lo, hi) == (at, at + size):
            take = lambda a: a.narrow(axis, at, size).clone()
        else:
            idx = torch.arange(at, at + size, device=dev).clamp(0, n - 1)
            take = lambda a: a.index_select(axis, idx)
        out = fn(*(a.map_cells(take) if hasattr(a, "map_cells")
                   else take(a) for a in arrays))
        single = isinstance(out, torch.Tensor)
        outs.append(tuple(o.narrow(axis, lo - at, hi - lo)
                          for o in ((out,) if single else out)))
    cat = tuple(torch.cat(parts, dim=axis) for parts in zip(*outs))
    return cat[0] if single else cat


class CellScatter(NamedTuple):
    """The scatter tables of a CellArrays' u and phi gather maps, with
    the global sizes, and which cells this process computes and how:
    `piece`, the card's cells per piece (`piece_size`; 0: none), and on
    W > 1 ranks of the replicated cell-axis mode `cells` (a
    `parallel.sharding.CellRange`), this process's range; the tables
    stay those of all cells.  A per-cell function goes through
    `cell_terms` (or `local`, for terms a process keeps)."""

    u: ScatterTable | None
    p: ScatterTable | None
    n_ud: int
    n_p: int
    cells: object = None
    piece: int = 0

    def own(self, ca):
        """This process's cells of the cell arrays of all cells."""
        return ca if self.cells is None else self.cells.own(ca)

    def local(self, fn, *arrays, axis: int = -1):
        """fn over this process's cells of `arrays` (as `own` gives
        them; cells on `axis`), in the card's pieces (`in_pieces`)."""
        return in_pieces(fn, self.piece,
                         0 if self.cells is None else self.cells.lo,
                         *arrays, axis=axis)

    def all_cells(self, *values, axis: int = -1):
        """Per-cell terms (cells on `axis`) of this process's cells ->
        those of all cells, in cell order, from one gather (the values
        themselves in one process), ready for the ordered scatter: every
        rank then sums each target's terms in the one-process order."""
        if self.cells is None:
            return values
        if axis == -1:
            return self.cells.gather(*values)
        return tuple(v.movedim(-1, axis) for v in self.cells.gather(
            *(v.movedim(axis, -1) for v in values)))

    def cell_terms(self, fn, *arrays, axis: int = -1):
        """`local`, then `all_cells`: the tuple of fn's per-cell terms of
        all cells."""
        out = self.local(fn, *arrays, axis=axis)
        return self.all_cells(
            *((out,) if isinstance(out, torch.Tensor) else out), axis=axis)


# the CellScatter of cells computed at once in one process, for a
# function that scatters through tables of its own
WHOLE = CellScatter(None, None, 0, 0)


def cell_scatter(ca, n_ud: int, n_p: int, piece: int = 0,
                 cells=None) -> CellScatter:
    return CellScatter(scatter_table(ca.gather_u), scatter_table(ca.gather_p),
                       n_ud, n_p, cells, piece)
