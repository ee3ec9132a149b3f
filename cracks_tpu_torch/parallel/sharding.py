"""Row-slab sharding of lattice-layout DoF vectors over D shards.

Port of the lattice part of ``cracks_tpu/parallel/sharding.py`` (the
device mesh, ``make_device_mesh``:51), of the padded row extent
``cracks_tpu/driver.py::System.lat_gyp`` (:160-192) and of
``cracks_tpu/solvers/lattice.py::_pad_rows/_unpad_rows`` (:1716-1732).

Execution model, the JAX package's own: one controller.  Code outside
the two sharded stencil wrappers (`ops.stencil.pad_jac_sharded`,
`ops.stencil.stencil_matvec_sharded`, JAX's two ``shard_map`` regions)
is global-view torch code on whole tensors; under JAX, GSPMD partitions
it.  Inside the wrappers the work is per shard: the J carrier holds one
slab per shard, built once per solve with an explicit halo exchange
(`ppermute_rows`); the product's plain version writes out the per-shard
X and its exchange, while its CUDA kernel is one launch for all shards
that reads the halo rows from the neighbour slabs of the global X.

Layout: a vertex lattice with G0 rows along its leading grid axis is
padded with zero rows to gyp = ceil(G0/D)*D, and shard i owns rows
[i*rows_loc, (i+1)*rows_loc) with rows_loc = gyp/D.

Where shards live: in one process all D shards sit on the run's one
device, as the JAX tests run 8 virtual CPU devices on one host.  On W
ranks (torch.distributed, one process per rank, `dist.py`) rank r
holds the D/W consecutive shards from r * D/W on its own device; the
halo pool runs there (the lattice layout and the replicated cell-axis
mode on W > 1 are ROADMAP A11d and A11e).  The JAX placements under
GSPMD -- ``shard_cell_core``, ``shard_cell_arrays``,
``shard_cell_arrays_nopad``, ``pad_cell_arrays``
(``parallel/sharding.py:102-173``) and ``lattice._maybe_shard_jacs``
(``lattice.py:1735``) -- move no value between shards and change no
result, so on one device they are no-ops and have no code here.  That
is all the replicated cell-axis mode (``n_devices > 1`` with replicated
DoF vectors) is: the port runs it as the one-shard run.

The product mesh (``mesh_dcn > 1``, JAX's ("dcn", "cells") mesh) keeps
the flat partition: the same D shards in the same order, since
``jax.devices()`` is process-major.  Only the lowering of JAX's
collectives changes, so here it is the mesh's shape and nothing else.

Collectives: the code of the sharded modes reaches other shards only
through `psum_shards`, `pmax_shards` (JAX's ``psum`` / ``pmax`` over the
shard axis) and `ppermute_rows`.  On one device they are tensor ops
across the leading shard axis, the sum in shard order so that every run
gives the same bits.  On W ranks `psum_shards` gathers every rank's
entries and sums them in the same shard order, so each rank holds the
one-process bits; `pmax_shards` is an all-reduce of the maximum, exact
in any order; `ppermute_rows` (the lattice layout) stays in one
process.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import dist


class ShardMesh(NamedTuple):
    """D shards: row slabs of the leading grid axis (the lattice layout)
    or contiguous cell ranges (the halo pool).  `dcn` is the product
    mesh's leading extent (1: the flat mesh).  With `ranks` (a process
    group of W > 1 ranks) this process holds the D / W shards from
    `first` on `device`."""

    n_shards: int
    device: torch.device
    dcn: int = 1
    ranks: dist.Ranks | None = None

    @property
    def rank(self) -> int:
        return 0 if self.ranks is None else self.ranks.rank

    @property
    def world(self) -> int:
        """W: the processes the shards are spread over."""
        return 1 if self.ranks is None else self.ranks.world

    @property
    def n_local(self) -> int:
        """Shards this process holds."""
        return self.n_shards // self.world

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.n_local

    @property
    def shape(self) -> tuple[int, ...]:
        """The mesh's shape: (D,) flat, (dcn, D / dcn) as a product."""
        if self.dcn == 1:
            return (self.n_shards,)
        return (self.dcn, self.n_shards // self.dcn)

    def padded(self, g0: int) -> int:
        """gyp: the leading extent g0 padded to a multiple of D."""
        return -(-g0 // self.n_shards) * self.n_shards

    def rows_loc(self, g0: int) -> int:
        """Rows each shard owns of a g0-row lattice."""
        return self.padded(g0) // self.n_shards


def make_shard_mesh(devices: Sequence, dcn: int = 1,
                    ranks: dist.Ranks | None = None) -> ShardMesh:
    """One shard per entry of `devices`; with dcn > 1 the product mesh's
    shape (JAX ``make_device_mesh``:51-81), whose `dcn` must divide D
    (ValueError, as in JAX).  In one process all shards sit on one
    device: entries naming several devices raise NotImplementedError
    (one process per device is the port's idiom, A11c).  With `ranks`
    of world W > 1, W must divide D (ValueError) and this rank's D / W
    entries must name its own device."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a shard mesh needs at least one shard")
    if dcn > 1 and len(devs) % dcn:
        raise ValueError(f"dcn={dcn} does not divide n_devices={len(devs)}")
    world = 1 if ranks is None else ranks.world
    if len(devs) % world:
        raise ValueError(f"the world size {world} does not divide "
                         f"n_devices={len(devs)}")
    rank = 0 if ranks is None else ranks.rank
    n_local = len(devs) // world
    mine = devs[rank * n_local:(rank + 1) * n_local]
    dev = mine[0]
    if dev.type == "cuda" and dev.index is None:
        # the device a tensor made on "cuda" reports
        dev = torch.device("cuda", torch.cuda.current_device())
    if len(set(mine)) > 1:
        raise NotImplementedError(
            f"shards on {len(set(mine))} distinct devices in one process "
            f"({sorted(map(str, set(mine)))}): the port drives one device "
            "per process; run one rank per card (torchrun, ROADMAP A11c)")
    if ranks is not None and world > 1 and dev != ranks.device:
        raise ValueError(f"rank {rank}'s shards name {dev}, its device is "
                         f"{ranks.device}")
    return ShardMesh(len(devs), dev, max(dcn, 1),
                     ranks if world > 1 else None)


def gather_shards(x: torch.Tensor, mesh: ShardMesh | None = None
                  ) -> torch.Tensor:
    """Every shard's entry of a (D_local, ...) tensor: (D, ...), in
    shard order (x itself in one process)."""
    if mesh is None or mesh.world == 1:
        return x
    return dist.all_gather_shards(x, mesh.ranks)


def _in_shard_order(full: torch.Tensor) -> torch.Tensor:
    total = full[0]
    for s in range(1, full.shape[0]):
        total = total + full[s]
    return total


def psum_shards(x: torch.Tensor, mesh: ShardMesh | None = None, *,
                host: bool = False):
    """JAX's ``psum`` over the shard axis: x is (D_local, ...) with one
    entry per shard of this process; every entry of the result is the
    total over all D shards, summed in shard order.  Returns a view of
    one total in x's shape; with `host`, (that view, the total as a
    host tensor).  Ranks that stage through host memory sum on the host
    (the same IEEE adds in the same order, so the same bits), and their
    host total costs no wait; elsewhere it is a copy from the device."""
    if mesh is not None and mesh.world > 1 and mesh.ranks.staged:
        total_h = _in_shard_order(
            dist.all_gather_shards(x, mesh.ranks, to_host=True))
        view = dist.to_device(total_h, x.device).unsqueeze(0).expand(
            x.shape)
        return (view, total_h) if host else view
    total = _in_shard_order(gather_shards(x, mesh))
    view = total.unsqueeze(0).expand(x.shape)
    return (view, total.cpu()) if host else view


def pmax_shards(x: torch.Tensor, mesh: ShardMesh | None = None
                ) -> torch.Tensor:
    """JAX's ``pmax`` over the shard axis: every entry of the result is
    the largest over all D shards.  Returns a view in x's shape."""
    top = x.amax(dim=0, keepdim=True)
    if mesh is not None and mesh.world > 1:
        top = dist.all_max(top, mesh.ranks)
    return top.expand(x.shape)


def pad_rows(X, gyp: int):
    """Pad the leading grid axis of a (k, G0, ...) lattice vector with
    zero rows to gyp rows."""
    pad = gyp - X.shape[1]
    if pad == 0:
        return X
    return torch.cat([X, X.new_zeros((X.shape[0], pad) + X.shape[2:])],
                     dim=1)


def unpad_rows(X, g0: int):
    """Drop the pad rows: (k, gyp, ...) -> (k, g0, ...) (a view)."""
    return X if X.shape[1] == g0 else X[:, :g0]


def ppermute_rows(slabs, shift: int, halos) -> None:
    """The non-circular ``jax.lax.ppermute`` of one row slab per shard
    along the shard axis, with the pairs (i, i+1) for shift +1 and
    (i+1, i) for shift -1: shard i's slab is copied into the halo slot
    of shard i+shift, and the halo slot that no shard sends to is
    zeroed (the boundary shard's)."""
    D = len(slabs)
    if len(halos) != D or shift not in (1, -1):
        raise ValueError(f"{D} slabs, {len(halos)} halo slots, shift "
                         f"{shift}")
    for i in range(D):
        j = i + shift
        if 0 <= j < D:
            halos[j].copy_(slabs[i])
    halos[0 if shift == 1 else D - 1].zero_()
