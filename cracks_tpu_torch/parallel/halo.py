"""The owned+ghost halo pool: sharded DoF vectors on general meshes
(torch).

Port of ``cracks_tpu/parallel/halo.py``, the sharded-DoF mode of every
mesh the tensor-grid lattice cannot hold (locally pre-refined meshes,
every adaptive epoch).  Each of D shards owns a contiguous Morton range
of cells and the vertices attached to them, and stores only its own and
ghost slots; every exchange between shards is one primitive over the
pool of the B interface vertices: scatter-add into per-shard pools,
`psum_shards`, gather.  A ghost read publishes the owners' values (the
reference's ``rel_solution = solution``, cracks.cc:2147); a combine
totals the partial sums of interface rows and hands them to their owners
(``compress(add)``, cracks.cc:2470).  Each shard's vertex set is
extended with the masters of its hanging vertices, so the hanging-node
constraints are shard-local (solvers/halo_newton.py).

Layout, all of a process's shards in one launch: every pooled vector
is (D_local, n_loc * comps), slot order per shard [owned | ghost | pad |
trash], the trash slot n_loc - 1.  JAX's per-shard cell tables ((D,
..., C)) are flattened into one `physics.CellArrays` over the D_local *
C cells (`HaloPartition.ca`, shard-major), each shard's gathers offset
by its local index * n_loc (* dim for u) into the flattened (D_local *
n_loc) vector, so each per-shard step of JAX's ``shard_map`` bodies is
one batched call of the port's `ops/physics.py` for the process's
shards.  In one process D_local = D.  On W ranks every rank builds the
whole partition on the host (it is deterministic, so every rank builds
the same one) and moves to its device only the rows of its own D / W
shards; the pool sums go through `psum_shards` across the ranks, and
`local_to_global_*` gathers every rank's owned slots.  JAX's
``halo_specs``, ``device_put_partition`` and ``_shard_ca`` are
``shard_map`` plumbing and have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import fem
from ..ops import physics
from ..ops.scatter import CellScatter, ScatterTable, cell_scatter, scatter_table
from .sharding import ShardMesh, gather_shards, psum_shards


class HaloArrays(NamedTuple):
    """Device tensors, each with the leading axis of the process's
    D_local shards (JAX's HaloArrays without its cell tables, which
    `HaloPartition.ca` holds flattened)."""

    own_mask_p: torch.Tensor   # (D, n_loc) bool: slot owned (not pad)
    loc2glob: torch.Tensor     # (D, n_loc) int64: global vertex (or n_v)
    loc2pool: torch.Tensor     # (D, n_loc) int64: pool slot (or B)
    is_ghost: torch.Tensor     # (D, n_loc) bool
    # hanging-node stencils in LOCAL slot indices (pad rows point at the
    # trash slot with zero weights)
    hang_child: torch.Tensor   # (D, H) int64
    hang_masters: torch.Tensor  # (D, H, 4) int64
    hang_weights: torch.Tensor  # (D, H, 4) float64
    hang_mask: torch.Tensor    # (D, n_loc) bool: slot is hanging


@dataclass(frozen=True)
class HaloPartition:
    arrays: HaloArrays
    n_loc: int                 # local vertex slots per shard (incl. trash)
    n_pool: int                # B interface vertices
    n_shards: int              # D, over all ranks
    dim: int
    n_vertices: int            # global count
    ca: physics.CellArrays     # the D_local * C cells, shard-major
    cs: CellScatter            # its ordered scatter tables
    pool_pos: torch.Tensor     # flat (D_local * n_loc) slots with a pool slot
    pool_tgt: torch.Tensor     # their flat (D_local * (B + 1)) pool positions
    hang_scatter: ScatterTable  # the masters' rows, flat (D_local * n_loc)
    # every owned slot of all D shards: its flat (D * n_loc) position and
    # its global vertex (the gather of local_to_global_*)
    own_pos: torch.Tensor
    own_glob: torch.Tensor
    mesh: ShardMesh | None = None  # the ranks (None: one process)

    @property
    def n_local(self) -> int:
        """D_local: the shards this process holds."""
        return self.n_shards if self.mesh is None else self.mesh.n_local


def _local_cell_arrays(mesh, lam, mu, cells_s, g2l):
    """Per-shard cell tables over LOCAL vertex indices (host numpy)."""
    t = fem.element_tables(mesh.dim)
    cc = mesh.cell_coords[cells_s]
    JxW, grads = fem.cell_geometry(cc, t)
    dim = mesh.dim
    nvc = mesh.cell2vert.shape[1]
    c2v_loc = g2l[mesh.cell2vert[cells_s]].astype(np.int64)   # (c, nvc)
    gather_u = (c2v_loc[:, :, None] * dim
                + np.arange(dim)[None, None, :]).reshape(len(cells_s),
                                                         nvc * dim).T
    lam_arr = np.broadcast_to(np.asarray(lam, np.float64),
                              (mesh.n_cells,))[cells_s]
    mu_arr = np.broadcast_to(np.asarray(mu, np.float64),
                             (mesh.n_cells,))[cells_s]
    return [gather_u, c2v_loc.T, JxW.T, np.transpose(grads, (1, 2, 3, 0)),
            lam_arr, mu_arr, 1.0 / mesh.diameters[cells_s] ** 2]


def build_halo_partition(mesh, lam, mu, n_shards: int, *,
                         dtype=torch.float64, device,
                         shard_mesh: ShardMesh | None = None
                         ) -> HaloPartition:
    """Host-side construction (JAX ``build_halo_partition``, copied
    exactly): contiguous Morton cell ranges (the forest sorts cells along
    its space-filling curve), vertex ownership by the lowest shard that
    touches the vertex through a cell, the pool = the vertices seen by
    more than one shard.  On meshes with hanging nodes each shard's
    vertex set is extended with the masters of its hanging vertices, so
    H / H^T are shard-local; "seen by" uses the extended sets.  With a
    `shard_mesh` of W > 1 ranks only this rank's shards reach
    `device`."""
    n_c, n_v, dim = mesh.n_cells, mesh.n_vertices, mesh.dim
    bounds = np.linspace(0, n_c, n_shards + 1).astype(np.int64)
    shard_of_cell = np.searchsorted(bounds[1:], np.arange(n_c), "right")

    # vertex -> masters map for hanging vertices (no chains)
    n_h = len(mesh.hang_child)
    hang_of = np.full(n_v, -1, np.int64)
    if n_h:
        hang_of[mesh.hang_child] = np.arange(n_h)
        if (hang_of[mesh.hang_masters.ravel()] >= 0).any():
            raise ValueError("hanging-constraint chain (a master is "
                             "itself hanging) — unsupported, like the "
                             "flat path")

    # per-shard extended vertex sets (cells' vertices + hang masters)
    vert_sets = []
    for s in range(n_shards):
        cells_s = np.arange(bounds[s], bounds[s + 1])
        verts_s = np.unique(mesh.cell2vert[cells_s])
        if n_h:
            h = hang_of[verts_s]
            hm = mesh.hang_masters[h[h >= 0]]
            verts_s = np.unique(np.concatenate([verts_s, hm.ravel()]))
        vert_sets.append(verts_s)

    # ownership by the lowest CELL-touching shard; pool = seen by more
    # than one shard under the extended sets
    owner = np.full(n_v, n_shards, np.int64)
    np.minimum.at(owner, mesh.cell2vert.ravel(),
                  np.repeat(shard_of_cell, mesh.cell2vert.shape[1]))
    seen = np.zeros(n_v, np.int64)
    for verts_s in vert_sets:
        seen[verts_s] += 1
    pool_vert = np.nonzero(seen > 1)[0]
    B = len(pool_vert)
    pool_slot = np.full(n_v, B, np.int64)
    pool_slot[pool_vert] = np.arange(B)

    shards = []
    C_max = V_max = H_max = 0
    hang_mask_g = np.zeros(n_v, bool)
    if n_h:
        hang_mask_g[mesh.hang_child] = True
    for s in range(n_shards):
        cells_s = np.arange(bounds[s], bounds[s + 1])
        verts_s = vert_sets[s]
        own = verts_s[owner[verts_s] == s]
        ghost = verts_s[owner[verts_s] != s]
        hloc = np.nonzero(hang_mask_g[verts_s])[0]
        shards.append((cells_s, own, ghost, verts_s[hloc]))
        C_max = max(C_max, len(cells_s))
        V_max = max(V_max, len(own) + len(ghost))
        H_max = max(H_max, len(hloc))
    n_loc = V_max + 1          # + the trash slot (pad cells point here)

    ca_parts = []
    own_mask = np.zeros((n_shards, n_loc), bool)
    loc2glob = np.full((n_shards, n_loc), n_v, np.int64)
    loc2pool = np.full((n_shards, n_loc), B, np.int64)
    is_ghost = np.zeros((n_shards, n_loc), bool)
    hang_mask_l = np.zeros((n_shards, n_loc), bool)
    h_child = np.full((n_shards, H_max), n_loc - 1, np.int64)
    h_masters = np.full((n_shards, H_max, 4), n_loc - 1, np.int64)
    h_weights = np.zeros((n_shards, H_max, 4))
    for s, (cells_s, own, ghost, hverts) in enumerate(shards):
        g2l = np.full(n_v + 1, n_loc - 1, np.int64)   # default: trash
        g2l[own] = np.arange(len(own))
        g2l[ghost] = len(own) + np.arange(len(ghost))
        own_mask[s, : len(own)] = True
        lv = np.concatenate([own, ghost])
        loc2glob[s, : len(lv)] = lv
        loc2pool[s, : len(lv)] = pool_slot[lv]
        is_ghost[s, len(own): len(lv)] = True
        hang_mask_l[s, g2l[hverts]] = True
        if len(hverts):
            hidx = hang_of[hverts]
            h_child[s, : len(hverts)] = g2l[hverts]
            h_masters[s, : len(hverts)] = g2l[mesh.hang_masters[hidx]]
            h_weights[s, : len(hverts)] = mesh.hang_weights[hidx]
        parts = _local_cell_arrays(mesh, lam, mu, cells_s, g2l)
        pad = C_max - len(cells_s)
        if pad:
            fills = [(n_loc - 1) * dim, n_loc - 1, 0, 0, 1, 1, 1]
            for i, (a, fill) in enumerate(zip(parts, fills)):
                widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
                parts[i] = np.pad(a, widths, constant_values=fill)
        ca_parts.append(parts)

    i64 = dict(dtype=torch.int64, device=device)
    flt = dict(dtype=dtype, device=device)
    dev = lambda a, kw: torch.as_tensor(np.ascontiguousarray(a), **kw)
    b = dict(dtype=torch.bool, device=device)
    # the gather of local_to_global_*, over all D shards
    own_pos = np.nonzero(own_mask.reshape(-1))[0]
    own_glob = loc2glob.reshape(-1)[own_pos]
    # this process's shards
    if shard_mesh is not None and shard_mesh.world > 1:
        lo = shard_mesh.first
        mine = slice(lo, lo + shard_mesh.n_local)
        own_mask, loc2glob, loc2pool, is_ghost, hang_mask_l = (
            a[mine] for a in (own_mask, loc2glob, loc2pool, is_ghost,
                              hang_mask_l))
        h_child, h_masters, h_weights = (a[mine] for a in (
            h_child, h_masters, h_weights))
        ca_parts = ca_parts[mine]
        shards = shards[mine]
    else:
        shard_mesh = None
    n_local = len(shards)
    arrays = HaloArrays(
        own_mask_p=dev(own_mask, b), loc2glob=dev(loc2glob, i64),
        loc2pool=dev(loc2pool, i64), is_ghost=dev(is_ghost, b),
        hang_child=dev(h_child, i64), hang_masters=dev(h_masters, i64),
        hang_weights=dev(h_weights, dict(dtype=torch.float64,
                                         device=device)),
        hang_mask=dev(hang_mask_l, b))

    # the flattened cells: local shard s's gathers offset into the
    # (D_local * n_loc) vector, the shard axis folded into the cell axis
    # (shard-major)
    shard = np.arange(n_local)
    offsets = [shard * n_loc * dim, shard * n_loc, 0, 0, 0, 0, 0]

    def flat(i, kw):
        a = np.stack([p[i] for p in ca_parts])            # (D, ..., C)
        a = a + np.reshape(offsets[i], (-1,) + (1,) * (a.ndim - 1))
        return dev(np.moveaxis(a, 0, -2).reshape(a.shape[1:-1] + (-1,)),
                   kw)

    ca = physics.CellArrays(
        gather_u=flat(0, i64), gather_p=flat(1, i64), JxW=flat(2, flt),
        grads=flat(3, flt),
        shape_v=dev(fem.element_tables(dim).shape_v, flt),
        lam=flat(4, flt), mu=flat(5, flt), inv_diam2=flat(6, flt))
    cs = cell_scatter(ca, n_local * n_loc * dim, n_local * n_loc)
    # the pool exchange's targets: one slot per (shard, pool vertex)
    on_pool = np.nonzero((loc2pool < B).reshape(-1))[0]
    pool_tgt = (np.repeat(shard, n_loc) * (B + 1)
                + loc2pool.reshape(-1))[on_pool]
    # H^T's targets: the masters of the real stencil rows (the pad rows'
    # zero-weight contributions to the trash slot, which H^T zeroes,
    # stay out of the table: a shard with few hanging vertices would
    # otherwise give the trash slot 4 (H - H_s) terms to sum in order)
    hang_tgt = (shard[:, None, None] * n_loc + h_masters).reshape(-1)
    n_hang = np.array([len(sh[3]) for sh in shards])
    real = np.repeat(np.arange(H_max)[None, :] < n_hang[:, None], 4,
                     axis=1).reshape(-1)
    return HaloPartition(
        arrays=arrays, n_loc=n_loc, n_pool=B, n_shards=n_shards, dim=dim,
        n_vertices=n_v, ca=ca, cs=cs, pool_pos=dev(on_pool, i64),
        pool_tgt=dev(pool_tgt, i64),
        hang_scatter=scatter_table(dev(hang_tgt, i64),
                                   dev(real, dict(dtype=torch.bool,
                                                  device=device))),
        own_pos=dev(own_pos, i64), own_glob=dev(own_glob, i64),
        mesh=shard_mesh)


# ---------------------------------------------------------------------------
# global <-> local redistribution (the Newton's boundary, and tests)
# ---------------------------------------------------------------------------

def global_to_local_p(part: HaloPartition, x: torch.Tensor) -> torch.Tensor:
    """A flat (n_v,) vector -> (D_local, n_loc), ghosts filled, pad and trash
    slots zero."""
    xe = torch.cat([x, x.new_zeros(1)])
    return xe[part.arrays.loc2glob]


def global_to_local_u(part: HaloPartition, x: torch.Tensor) -> torch.Tensor:
    """A flat (n_v * dim,) vector -> (D_local, n_loc * dim)."""
    xe = torch.cat([x.reshape(part.n_vertices, part.dim),
                    x.new_zeros((1, part.dim))])
    return xe[part.arrays.loc2glob].reshape(part.n_local, -1)


def _to_global(part: HaloPartition, xl: torch.Tensor, comps: int):
    """(D_local, n_loc * comps) -> the (n_v, comps) rows of the owned
    slots of all D shards (every rank's, gathered on W > 1 ranks)."""
    if part.mesh is not None:
        xl = gather_shards(xl, part.mesh)
    out = xl.new_zeros((part.n_vertices, comps))
    out[part.own_glob] = xl.reshape(-1, comps)[part.own_pos]
    return out


def local_to_global_p(part: HaloPartition, xl: torch.Tensor) -> torch.Tensor:
    """(D_local, n_loc) -> the flat (n_v,) vector of the owned slots."""
    return _to_global(part, xl, 1).reshape(-1)


def local_to_global_u(part: HaloPartition, xl: torch.Tensor) -> torch.Tensor:
    """(D_local, n_loc * dim) -> the flat (n_v * dim,) vector."""
    return _to_global(part, xl, part.dim).reshape(-1)


# ---------------------------------------------------------------------------
# the halo primitives, all shards at once
# ---------------------------------------------------------------------------

def write_pools(part: HaloPartition, vals: torch.Tensor) -> torch.Tensor:
    """Each shard's (n_loc, comps) values written into its own pool:
    (D_local, B+1, comps).  Within one shard a pool slot has at most one
    local slot, so the write is a scatter without duplicates."""
    D, comps = part.n_local, vals.shape[-1]
    pools = vals.new_zeros((D * (part.n_pool + 1), comps))
    pools[part.pool_tgt] = vals.reshape(-1, comps)[part.pool_pos]
    return pools.reshape(D, part.n_pool + 1, comps)


def _pool_exchange(part: HaloPartition, vals: torch.Tensor) -> torch.Tensor:
    """The pools of `write_pools` summed over all shards: the (D_local,
    B+1, comps) totals."""
    return psum_shards(write_pools(part, vals), part.mesh)


def read_pools(part: HaloPartition, pool: torch.Tensor) -> torch.Tensor:
    """Each slot's row of its shard's pool: (D_local, n_loc, comps)."""
    shard = torch.arange(part.n_local, device=pool.device)[:, None]
    return pool[shard, part.arrays.loc2pool]


def make_halo_ops(part: HaloPartition):
    """(ghost_read_u, ghost_read_p, combine_u, combine_p) on (D_local,
    n_loc * comps) vectors.  A ghost read refreshes the ghost slots from their
    owners; a combine totals every interface row over the shards and
    keeps the owned rows (ghost, pad and trash slots zero)."""
    arr = part.arrays
    n_loc, dim = part.n_loc, part.dim
    on_pool = (arr.loc2pool < part.n_pool)[..., None]
    own = arr.own_mask_p[..., None]
    ghost = arr.is_ghost[..., None]

    def ghost_read(x, comps):
        xm = x.reshape(part.n_local, n_loc, comps)
        pool = _pool_exchange(part, torch.where(own, xm, 0.0))
        xm = torch.where(ghost, read_pools(part, pool), xm)
        return xm.reshape(x.shape)

    def combine(r, comps):
        rm = r.reshape(part.n_local, n_loc, comps)
        pool = _pool_exchange(part, rm)
        rm = torch.where(on_pool, read_pools(part, pool), rm)
        rm = torch.where(own, rm, 0.0)
        return rm.reshape(r.shape)

    return (lambda x: ghost_read(x, dim), lambda x: ghost_read(x, 1),
            lambda r: combine(r, dim), lambda r: combine(r, 1))


def halo_residual_fn(part: HaloPartition, *, with_split: bool):
    """The residual on pooled vectors (JAX ``halo_residual_fn``): inputs
    (D_local, n_loc * dim) / (D_local, n_loc), ghosts refreshed inside; outputs
    owner-combined (ghost, pad and trash slots zero).  No hanging-node
    constraints (solvers/halo_newton.py adds them)."""
    gr_u, gr_p, cb_u, cb_p = make_halo_ops(part)

    def fn(u, phi, phi_old, phi_oold, sc):
        ru, rp = physics.assemble_residual(
            gr_u(u).reshape(-1), gr_p(phi).reshape(-1),
            gr_p(phi_old).reshape(-1), gr_p(phi_oold).reshape(-1), part.ca,
            sc, part.cs, dim=part.dim, with_split=with_split,
            monolithic=False)
        return (cb_u(ru.reshape(u.shape)), cb_p(rp.reshape(phi.shape)))

    return fn
