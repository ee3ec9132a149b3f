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
bits come out of every run on the card.
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


class CellScatter(NamedTuple):
    """The scatter tables of a CellArrays' u and phi gather maps, with
    the global sizes."""

    u: ScatterTable
    p: ScatterTable
    n_ud: int
    n_p: int


def cell_scatter(ca, n_ud: int, n_p: int) -> CellScatter:
    return CellScatter(scatter_table(ca.gather_u), scatter_table(ca.gather_p),
                       n_ud, n_p)
