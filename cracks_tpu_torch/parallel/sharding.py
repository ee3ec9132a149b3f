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

Where shards live: all D shards sit on the run's one device, as the
JAX tests run 8 virtual CPU devices on one host.  Shards on several
cards (NCCL or peer copies) are ROADMAP A11b, and asking for them
raises.  The JAX placements under GSPMD -- ``shard_cell_arrays_nopad``
(``parallel/sharding.py:146``) and ``lattice._maybe_shard_jacs``
(``lattice.py:1735``) -- move no value between shards and change no
result, so on one device they are no-ops and have no code here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class ShardMesh(NamedTuple):
    """D row-slab shards of the leading grid axis, on one device."""

    n_shards: int
    device: torch.device

    def padded(self, g0: int) -> int:
        """gyp: the leading extent g0 padded to a multiple of D."""
        return -(-g0 // self.n_shards) * self.n_shards

    def rows_loc(self, g0: int) -> int:
        """Rows each shard owns of a g0-row lattice."""
        return self.padded(g0) // self.n_shards


def make_shard_mesh(devices: Sequence) -> ShardMesh:
    """One shard per entry of `devices`, all on one device.  Shards on
    more than one distinct device raise NotImplementedError (A11b)."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a shard mesh needs at least one shard")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"shards on {len(set(devs))} distinct devices "
            f"({sorted(map(str, set(devs)))}): several cards through "
            "torch.distributed/NCCL or peer copies are ROADMAP A11b; the "
            "port runs all D shards on one device")
    dev = devs[0]
    if dev.type == "cuda" and dev.index is None:
        # the device a tensor made on "cuda" reports
        dev = torch.device("cuda", torch.cuda.current_device())
    return ShardMesh(len(devs), dev)


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
