"""Row-slab sharding of lattice-layout DoF vectors over D shards.

Port of the lattice part of ``cracks_tpu/parallel/sharding.py`` (the
device mesh, ``make_device_mesh``:51), of the padded row extent
``cracks_tpu/driver.py::System.lat_gyp`` (:160-192) and of
``cracks_tpu/solvers/lattice.py::_pad_rows/_unpad_rows`` (:1716-1732).

Layout: a vertex lattice with G0 rows along its leading grid axis is
padded with zero rows to gyp = ceil(G0/D)*D, and shard i owns rows
[i*rows_loc, (i+1)*rows_loc) with rows_loc = gyp/D.

Where shards live: in one process all D shards sit on the run's one
device, as the JAX tests run 8 virtual CPU devices on one host.  On W
ranks (torch.distributed, one process per rank, `dist.py`) rank r
holds the D/W consecutive shards from r * D/W on its own device.  The
JAX placements under GSPMD -- ``shard_cell_core``,
``shard_cell_arrays``, ``shard_cell_arrays_nopad`` (``parallel/
sharding.py:126-173``) and ``lattice._maybe_shard_jacs``
(``lattice.py:1735``) -- move no value between shards and change no
result, so on one device they are no-ops and have no code here.  That
is all the replicated cell-axis mode (``n_devices > 1`` with replicated
DoF vectors) is in one process: the port runs it as the one-shard run.
On W > 1 ranks it splits the cell axis as ``pad_cell_arrays``
(``:102-124``) pads it (`CellRange`): every rank holds the whole DoF
vectors and computes the per-cell terms of its shards' cells only,
and every sum over cells gathers all ranks' terms in cell order before
the one-process ordered scatter (`ops.scatter`), so every rank holds
the one-process vector bit for bit.

The lattice layout splits the finest levels of the lattice GMG by
slab (`Slab`, `level_slabs`): at level l (2:1 coarser per level) shard
i owns the rows [ceil(min(i*rows_loc, G0) / 2**l), ...) up to the next
shard's first row, so a coarse vertex belongs to the shard of its fine
parent vertex (across a seam the upper lip's rows have odd parents,
`level_bounds`); a process holds its shards' rows of every vector, mask
and element-matrix level split so and reaches its neighbours' boundary
rows through one exchange per product (`Slab.ext`).  Where JAX's GSPMD
partitions global-view code, the port runs the same code on a
process's halo'd rows.  Its dot products are sums of per-row sums
(`Slab.dots`, `row_sums`): rows are the one partition that every D and
W share, so every such run holds the same bits.

The product mesh (``mesh_dcn > 1``, JAX's ("dcn", "cells") mesh) keeps
the flat partition: the same D shards in the same order, since
``jax.devices()`` is process-major.  Only the lowering of JAX's
collectives changes, so here it is the mesh's shape and nothing else.

Collectives: the code of the sharded modes reaches other shards only
through `psum_shards`, `pmax_shards` (JAX's ``psum`` / ``pmax`` over the
shard axis), `ppermute_rows` and `Slab`'s exchanges and gathers.  On one device
they are tensor ops across the leading shard axis, the sum in shard
order so that every run gives the same bits.  On W ranks `psum_shards`
gathers every rank's entries and sums them in the same shard order, so
each rank holds the one-process bits; `pmax_shards` is an all-reduce of
the maximum, exact in any order; a row exchange is one round of sends
to the neighbour ranks (`dist.exchange_rows`).
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


class CellRange(NamedTuple):
    """The replicated cell-axis mode's split of a mesh's n_cells cells
    over the D shards of `mesh` (JAX ``pad_cell_arrays``): the cell axis
    padded with zero-JxW cells to D * m, m = ceil(n_cells / D), shard i
    owning the cells [i * m, (i+1) * m).  This process holds its shards'
    consecutive cells [lo, hi), one range: (D / W) * m cells, pad cells
    included on the last rank.  The halo pool's ranges
    (`halo.build_halo_partition`, ``np.linspace`` bounds) are another
    partition, as in JAX."""

    n_cells: int
    mesh: ShardMesh

    @property
    def per_shard(self) -> int:
        return -(-self.n_cells // self.mesh.n_shards)

    @property
    def lo(self) -> int:
        return self.mesh.first * self.per_shard

    @property
    def hi(self) -> int:
        return self.lo + self.mesh.n_local * self.per_shard

    def take(self, a, fill=0):
        """This process's cells [lo, hi) of a per-cell array (cell axis
        last), the pad cells set to `fill`."""
        pad = self.mesh.n_shards * self.per_shard - a.shape[-1]
        if pad:
            a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), fill)], -1)
        return a[..., self.lo:self.hi].contiguous()

    def own(self, ca):
        """This process's cells of the cell arrays `ca` (a
        `physics.CellArrays`): the pad cells have zero JxW (no
        contribution anywhere), gathers at DoF 0 and unit Lame and
        diameter fields, as JAX pads them."""
        t = self.take
        return ca._replace(
            gather_u=t(ca.gather_u), gather_p=t(ca.gather_p), JxW=t(ca.JxW),
            grads=t(ca.grads), lam=t(ca.lam, 1), mu=t(ca.mu, 1),
            inv_diam2=t(ca.inv_diam2, 1))

    def gather(self, *values):
        """Every process's per-cell terms, in cell order: each value
        (..., hi - lo) with the cell axis last (one dtype for all)
        becomes (..., n_cells), the pad cells dropped, from one gather
        of all of them.  In one process (W = 1) the values
        themselves."""
        if self.mesh.world == 1:
            return values
        m = self.hi - self.lo
        flat = torch.cat([v.reshape(-1, m) for v in values])
        dist.CELL_GATHERS["gathers"] += 1
        dist.CELL_GATHERS["bytes"] += flat.numel() * flat.element_size()
        every = dist.all_gather_shards(flat.unsqueeze(0), self.mesh.ranks)
        every = every.permute(1, 0, 2).reshape(flat.shape[0], -1)
        out, at = [], 0
        for v in values:
            rows = v.numel() // m
            out.append(every[at:at + rows, :self.n_cells].reshape(
                v.shape[:-1] + (self.n_cells,)))
            at += rows
        return tuple(out)


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


def ppermute_rows(slabs, shift: int, halos, mesh: ShardMesh | None = None
                  ) -> None:
    """The non-circular ``jax.lax.ppermute`` of one row slab per shard
    along the shard axis, with the pairs (i, i+1) for shift +1 and
    (i+1, i) for shift -1: shard i's slab is copied into the halo slot
    of shard i+shift, and the halo slot that no shard sends to is
    zeroed (the boundary shard's).  `slabs` and `halos` are this
    process's shards'; on W > 1 ranks (`mesh`) the slab that crosses a
    rank boundary goes to the neighbour rank in one exchange."""
    D = len(slabs)
    if len(halos) != D or shift not in (1, -1):
        raise ValueError(f"{D} slabs, {len(halos)} halo slots, shift "
                         f"{shift}")
    for i in range(D):
        j = i + shift
        if 0 <= j < D:
            halos[j].copy_(slabs[i])
    edge = 0 if shift == 1 else D - 1
    if mesh is None or mesh.world == 1:
        halos[edge].zero_()
        return
    sender = slabs[D - 1 if shift == 1 else 0]
    to_next = mesh.rank + shift
    from_prev = mesh.rank - shift
    spec = (tuple(halos[edge].shape), halos[edge].dtype)
    got = dist.exchange_rows(
        mesh.ranks,
        down=sender if shift == -1 and to_next >= 0 else None,
        up=sender if shift == 1 and to_next < mesh.world else None,
        from_below=spec if shift == 1 and from_prev >= 0 else None,
        from_above=spec if shift == -1 and from_prev < mesh.world else None)
    got = got[0] if shift == 1 else got[1]
    if got is None:
        halos[edge].zero_()
    else:
        halos[edge].copy_(got)


# ---------------------------------------------------------------------------
# the lattice levels split by slab
# ---------------------------------------------------------------------------

# a coarse level is split by slab while every shard that holds lattice
# rows holds at least this many of its rows; below it every process
# holds the whole level (and runs it identically)
SPLIT_MIN_ROWS = 4


class Slab(NamedTuple):
    """This process's rows [a, b) of one level of a row-slab sharded
    lattice of g rows (the leading grid axis), on `mesh` (None: one
    process), with every rank's rows `spans` (W > 1 ranks).  The stencil
    reaches one row each way, so a row-local operation needs the halo'd
    rows [e0, e1) = [max(a-1, 0), min(b+1, g)): the owned rows and each
    neighbour's boundary row (`ext`); their cells [e0, e1-1) are the
    cells this process holds of the level.  In one process (a = 0,
    b = g) `ext` is the identity and no row moves."""

    g: int
    a: int
    b: int
    mesh: ShardMesh | None = None
    spans: tuple = ()

    @property
    def n(self) -> int:
        return self.b - self.a

    @property
    def e0(self) -> int:
        return max(self.a - 1, 0)

    @property
    def e1(self) -> int:
        return min(self.b + 1, self.g)

    @property
    def off(self) -> int:
        """The owned rows' offset in the halo'd rows (0 or 1)."""
        return self.a - self.e0

    @property
    def cells(self) -> tuple:
        """The cell rows [c0, c1) this process holds."""
        return self.e0, self.e1 - 1

    @property
    def ranked(self) -> bool:
        return self.mesh is not None and self.mesh.world > 1

    def rows(self, X):
        """The owned rows of a whole level (k, g, ...)."""
        return X[:, self.a:self.b]

    def owned(self, Y):
        """The owned rows of a halo'd (k, e1-e0, ...) array."""
        return Y[:, self.off:self.off + self.n]

    def ext(self, *Xs):
        """Owned (k, n, ...) arrays -> halo'd (k, e1-e0, ...) arrays:
        each neighbour's boundary rows of all of them in one exchange
        (the arrays share their dtype and row shape).  Returns a
        tuple."""
        if self.e0 == self.a and self.e1 == self.b:
            return Xs
        ks = [X.shape[0] for X in Xs]
        edge = lambda sl: torch.cat([X[:, sl] for X in Xs])
        spec = ((sum(ks), 1) + tuple(Xs[0].shape[2:]), Xs[0].dtype)
        lo, hi = dist.exchange_rows(
            self.mesh.ranks,
            down=edge(slice(0, 1)) if self.e0 < self.a else None,
            up=edge(slice(-1, None)) if self.e1 > self.b else None,
            from_below=spec if self.e0 < self.a else None,
            from_above=spec if self.e1 > self.b else None)
        out, at = [], 0
        for X, k in zip(Xs, ks):
            pieces = [X]
            if lo is not None:
                pieces.insert(0, lo[at:at + k])
            if hi is not None:
                pieces.append(hi[at:at + k])
            out.append(torch.cat(pieces, dim=1))
            at += k
        return tuple(out)

    def dots(self, *pairs, host: bool = False):
        """The totals x . y of each (x, y) pair of owned arrays: each
        row's partial sum (`row_sums`), every process's rows gathered,
        one sum over the level's rows.  Every process, and a run of the
        same lattice on any number of shards or ranks, holds the same
        bits (a sum of per-shard sums in shard order would not: the
        refinement pass's residual cancels ~4 digits, so its last bits
        move every f32 CG iterate).  Returns an (m,) tensor of x's
        dtype; with `host`, (it, the f64 totals on the host)."""
        part = row_sums(*pairs, a=self.a, g=self.g)
        if self.ranked:
            part = gather_rows(part[:, self.a:self.b], self.mesh,
                               self.spans)
        total = part.sum(dim=1)
        view = total.to(pairs[0][0].dtype)
        return (view, total.cpu()) if host else view

    def amax(self, x):
        """The elementwise largest of x over all processes (exact)."""
        return pmax_shards(x.unsqueeze(0), self.mesh)[0]

    def sum_ranks(self, x):
        """The sum of an integer tensor over all processes (exact)."""
        if not self.ranked:
            return x
        return dist.all_gather_shards(x.unsqueeze(0), self.mesh.ranks).sum(0)

    def gather(self, X):
        """The whole level (k, g, ...) from every process's owned rows
        (one gather; `X` itself in one process)."""
        if not self.ranked:
            return X
        if X.dtype == torch.bool:
            return gather_rows(X.to(torch.uint8), self.mesh,
                               self.spans).bool()
        return gather_rows(X, self.mesh, self.spans)


def whole(g: int) -> Slab:
    """The slab of all g rows of a level in one process."""
    return Slab(g, 0, g)


def row_sums(*pairs, a: int = 0, g: int | None = None) -> torch.Tensor:
    """(m, g) f64: for each (x, y) pair of (k, n, *rest) arrays, the
    rows [a, a+n) of a level of g rows (n if None), the sum of x * y
    over each row (axis 1) and its components: one `sum` of a
    (k, g, *rest) array that holds the products at their rows of the
    level (zeros elsewhere).  That reduction has the same shape, and a
    row the same place, in every process, so a row's sum has the same
    bits however many rows a process holds, on any device.  Rows outside
    [a, a+n) are 0."""
    sums = []
    for x, y in pairs:
        t = (x * y).to(torch.float64)
        n = t.shape[1]
        if g is not None and g != n:
            full = t.new_zeros((t.shape[0], g) + t.shape[2:])
            full[:, a:a + n] = t
            t = full
        sums.append(t.sum(dim=[0] + list(range(2, t.dim()))))
    return torch.stack(sums)


def coarse_rows_below(A: int, seam_row: int | None = None) -> int:
    """The rows of the 2:1-coarsened level whose fine parent row lies
    below fine row A: a coarse row c's parent is row 2c, or, across a
    seam whose lower-lip row is `seam_row` = s, 2c - 1 for the upper
    lip's rows c > s/2 (the mirror row s+1 starts the upper slab).  The
    same count maps cell rows: coarse cell c is made of the fine cells
    from that row on."""
    if seam_row is None or A <= seam_row + 1:
        return -(-A // 2)
    return seam_row // 2 + 1 + -(-(A - seam_row - 1) // 2)


def level_bounds(mesh: ShardMesh, g0: int, n_levels: int,
                 seam_row: int | None = None):
    """(grids, bounds): the rows of every level of a 2:1 lattice
    hierarchy whose finest level has g0 rows, finest first, and at each
    level the D+1 shard bounds, shard i owning rows [bounds[i],
    bounds[i+1]).  On a seam lattice (`seam_row`, the finest level's
    lower-lip row s) a level of g rows coarsens to (g-2)//2 + 2 and the
    seam row halves.  Each coarse row lies on the shard of its fine
    parent (`coarse_rows_below`), so the two lip rows of a coarse seam
    share a shard exactly when the fine ones do."""
    grids, seams = [g0], [seam_row]
    for _ in range(n_levels - 1):
        g, s = grids[-1], seams[-1]
        grids.append((g - 1) // 2 + 1 if s is None else (g - 2) // 2 + 2)
        seams.append(None if s is None else s // 2)
    rl = mesh.rows_loc(g0)
    bounds = [[min(i * rl, g0) for i in range(mesh.n_shards + 1)]]
    for s in seams[:-1]:
        bounds.append([coarse_rows_below(A, s) for A in bounds[-1]])
    return grids, bounds


def every_rank_has_rows(mesh: ShardMesh, g0: int) -> bool:
    """Whether each of the mesh's W ranks holds a row of a g0-row
    lattice (its last rank's first row lies inside)."""
    return (mesh.world - 1) * mesh.n_local * mesh.rows_loc(g0) < g0


def level_slabs(mesh: ShardMesh | None, g0: int, n_levels: int,
                seam_row: int | None = None):
    """This process's `Slab` of every level of a 2:1 lattice hierarchy
    whose finest level has g0 rows (on a seam lattice `seam_row`, see
    `level_bounds`), finest first, and the number of levels split by
    slab: the finest level and each next one while every shard holding
    lattice rows holds at least SPLIT_MIN_ROWS of its rows (never the
    coarsest, whose dense factor every process computes).  Without a
    mesh: one slab of all rows per level and no split level (the
    global-view solve).  On W > 1 ranks every rank must hold a row of
    the finest level (ValueError)."""
    if mesh is None:
        grids, _ = level_bounds(ShardMesh(1, torch.device("cpu")), g0,
                                n_levels, seam_row)
        return [whole(g) for g in grids], 0
    grids, level = level_bounds(mesh, g0, n_levels, seam_row)
    D, W, nl = mesh.n_shards, mesh.world, mesh.n_local
    first, last = mesh.first, mesh.first + nl
    slabs, sizes = [], []
    for l, (g, bounds) in enumerate(zip(grids, level)):
        sizes.append([bounds[i + 1] - bounds[i] for i in range(D)])
        spans = tuple((bounds[r * nl], bounds[(r + 1) * nl])
                      for r in range(W))
        if l == 0 and W > 1 and not every_rank_has_rows(mesh, g0):
            raise ValueError(f"{W} ranks of {D} shards leave a rank without "
                             f"rows of the {g0}-row lattice")
        slabs.append(Slab(g, bounds[first], bounds[last], mesh,
                          spans if W > 1 else ()))
    real = [i for i in range(D) if sizes[0][i]]
    n_split = 1
    while (n_split < n_levels - 1
           and min(sizes[n_split][i] for i in real) >= SPLIT_MIN_ROWS):
        n_split += 1
    return slabs, n_split


def gather_rows(X, mesh: ShardMesh, spans) -> torch.Tensor:
    """Concatenate every rank's rows along axis 1: this rank's X holds
    the rows spans[rank] = (a, b); one all-gather of the rows padded to
    the longest span."""
    longest = max(b - a for a, b in spans)
    pad = longest - X.shape[1]
    if pad:
        X = torch.cat([X, X.new_zeros((X.shape[0], pad) + X.shape[2:])], 1)
    full = dist.all_gather_shards(X.unsqueeze(0), mesh.ranks)
    return torch.cat([full[r, :, :b - a] for r, (a, b) in enumerate(spans)],
                     dim=1)

