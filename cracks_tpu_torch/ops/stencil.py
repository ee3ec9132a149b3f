"""The lattice block-stencil matvec: hand-written CUDA kernels (2d and
3d) and their plain PyTorch version.

For vertex (d, *v) of a uniform Q1 lattice with stored element
matrices J (R, C, *cellgrid):

    Y[d,v] = sum_{a,b,e} J[lo_r + a*k_out + d, lo_c + b*k_in + e, v-o_a]
                         * X[e, v-o_a+o_b]

over the 2**dim cell corners a, b (offset o_a per grid axis, slowest
to fastest: (oy, ox) = (a >> 1, a & 1) in 2d, (oz, oy, ox) =
((a >> 2) & 1, (a >> 1) & 1, a & 1) in 3d) and the k_in input
components e; cells outside the cell grid contribute nothing.  Rows
[lo_r, hi_r) and columns [lo_c, hi_c) of the local element matrices
select the block: the u block (k = dim), the phase-field block (k = 1)
or the rectangular J_pu coupling (k_in = dim, k_out = 1).

`stencil_matvec` dispatches on the rank of J (4: 2d, 5: 3d) and on the
device of X: a CUDA tensor goes to the kernel in
``csrc/lattice_stencil.cu`` (replacing the Pallas TPU kernel
``cracks_tpu/ops/pallas_stencil.py::_kernel``; its phase-field products
run the kernel of ``csrc/lattice_stencil2d_phi.cuh``) or
``csrc/lattice_stencil3d.cu`` (replacing ``::_kernel3d``; its f64
products stream J through ``csrc/lattice_stencil3d_stream.cuh``), or
raises; a CPU tensor goes to `stencil_matvec_reference`, the slice
formulation of ``cracks_tpu/solvers/lattice.py::matvec_block``.

`pad_jac_sharded` / `stencil_matvec_sharded` compute the same product
on a row-slab sharded lattice (``parallel/sharding.py``), replacing the
``shard_map`` wrappers of the Pallas kernels: one launch for all shards
of ``csrc/lattice_stencil_sharded.cu`` or
``csrc/lattice_stencil3d_sharded.cu``.
"""

from __future__ import annotations

import torch

from .. import kernels


def _corner_offsets(dim):
    """Corner a -> per-grid-axis offsets, slowest axis first."""
    return [tuple((a >> (dim - 1 - j)) & 1 for j in range(dim))
            for a in range(2 ** dim)]


def stencil_matvec_reference(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Plain PyTorch version, 2d and 3d: gather the 2**dim shifted cell
    windows of X, one batched per-cell product with the J block,
    scatter-add the 2**dim shifted windows back.  jac (R, C, *cellgrid);
    X (k_in, *grid) -> (k_out, *grid)."""
    grid = X.shape[1:]
    offs = _corner_offsets(len(grid))

    def win(o):
        return (slice(None),) + tuple(slice(oj, g - 1 + oj)
                                      for oj, g in zip(o, grid))

    Xf = torch.cat([X[win(o)] for o in offs])      # (nvc*k_in, *cellgrid)
    Yf = torch.einsum("ij...,j...->i...", jac[lo_r:hi_r, lo_c:hi_c], Xf)
    Y = torch.zeros((k_out,) + tuple(grid), dtype=X.dtype, device=X.device)
    for a, o in enumerate(offs):
        Y[win(o)] += Yf[a * k_out:(a + 1) * k_out]
    return Y


def _check(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Validate a kernel call: one device, f32 or f64 of one dtype,
    contiguous, matching cell/vertex grids, a block inside J."""
    dim = X.dim() - 1
    if jac.device != X.device:
        raise ValueError(f"jac on {jac.device}, X on {X.device}")
    if X.dtype not in (torch.float32, torch.float64) \
            or jac.dtype != X.dtype:
        raise TypeError(f"stencil_matvec takes f32 or f64 of one dtype, "
                        f"got jac {jac.dtype}, X {X.dtype}")
    if dim not in (2, 3) or jac.dim() != dim + 2:
        raise ValueError(f"need jac (R, C, *cellgrid) and X (k, *grid) in "
                         f"2d or 3d, got {tuple(jac.shape)}, "
                         f"{tuple(X.shape)}")
    if not (jac.is_contiguous() and X.is_contiguous()):
        raise ValueError("stencil_matvec needs contiguous jac and X")
    R, C = jac.shape[:2]
    if tuple(g - 1 for g in X.shape[1:]) != tuple(jac.shape[2:]):
        raise ValueError(f"cell grid {tuple(jac.shape[2:])} does not match "
                         f"vertex grid {tuple(X.shape[1:])}")
    if (k_in not in (1, dim) or k_out not in (1, dim)
            or X.shape[0] != k_in):
        raise ValueError(f"k_in={k_in}, k_out={k_out}, X has "
                         f"{X.shape[0]} components")
    nvc = 2 ** dim
    if not (0 <= lo_r and hi_r - lo_r == nvc * k_out and hi_r <= R
            and 0 <= lo_c and hi_c - lo_c == nvc * k_in and hi_c <= C):
        raise ValueError(f"block rows [{lo_r},{hi_r}) cols [{lo_c},{hi_c})"
                         f" does not fit jac {tuple(jac.shape)} with "
                         f"k_in={k_in}, k_out={k_out}")


def _launch(load, dim, jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Validate, then load the `dim`-d kernel library, allocate Y and
    launch its f32/f64 entry point on the current stream; raises on a
    tensor the kernel cannot take and on a refused launch."""
    if X.device.type != "cuda":
        raise ValueError(f"the {dim}d stencil kernel takes CUDA tensors, "
                         f"got {X.device}")
    if X.dim() != dim + 1:
        raise ValueError(f"the {dim}d stencil kernel got X "
                         f"{tuple(X.shape)}")
    _check(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out)
    lib = load()
    fn = lib.f32 if X.dtype == torch.float32 else lib.f64
    Y = torch.empty((k_out,) + tuple(X.shape[1:]), dtype=X.dtype,
                    device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(jac.data_ptr(), X.data_ptr(), Y.data_ptr(),
                 *jac.shape, lo_r, lo_c, k_in, k_out, stream)
    if err != 0:
        raise RuntimeError(f"{lib.name} launch failed: CUDA error {err}")
    return Y


def stencil_matvec2d(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """The 2d CUDA kernel on CUDA tensors (jac (R, C, GCY, GCX), X (k_in,
    GY, GX)); each launch adds one to `stencil_matvec2d.launches`, and a
    phase-field launch (k_in = k_out = 1: the kernel of
    ``csrc/lattice_stencil2d_phi.cuh``) also to
    `stencil_matvec2d.phi_launches`."""
    Y = _launch(kernels.lattice_stencil, 2, jac, X, lo_r, hi_r, lo_c, hi_c,
                k_in, k_out)
    stencil_matvec2d.launches += 1
    if k_in == k_out == 1:
        stencil_matvec2d.phi_launches += 1
    return Y


def stencil_matvec3d(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """The 3d CUDA kernel on CUDA tensors (jac (R, C, GCZ, GCY, GCX), X
    (k_in, GZ, GY, GX)); each launch adds one to
    `stencil_matvec3d.launches`, and an f64 launch (the streaming kernel
    of ``csrc/lattice_stencil3d_stream.cuh``) also to
    `stencil_matvec3d.f64_launches`."""
    Y = _launch(kernels.lattice_stencil3d, 3, jac, X, lo_r, hi_r, lo_c,
                hi_c, k_in, k_out)
    stencil_matvec3d.launches += 1
    if X.dtype == torch.float64:
        stencil_matvec3d.f64_launches += 1
    return Y


stencil_matvec2d.launches = 0
stencil_matvec2d.phi_launches = 0
stencil_matvec3d.launches = 0
stencil_matvec3d.f64_launches = 0


def stencil_matvec(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Y = J_block X on the lattice.  CPU tensors use the plain version;
    CUDA tensors launch the 2d or 3d kernel by the rank of jac."""
    if X.device.type == "cpu":
        return stencil_matvec_reference(jac, X, lo_r, hi_r, lo_c, hi_c,
                                        k_in, k_out)
    kernel = stencil_matvec3d if jac.dim() == 5 else stencil_matvec2d
    return kernel(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out)


# ---------------------------------------------------------------------------
# row-slab sharded products (parallel.sharding's layout)
# ---------------------------------------------------------------------------
#
# Port of ``cracks_tpu/ops/pallas_stencil.py::pad_jac_sharded`` /
# ``stencil_matvec_sharded`` (:140-204) and their 3d versions
# ``pad_jac3d_sharded`` / ``stencil_matvec3d_sharded`` (:335-404), the
# two ``shard_map`` regions of the lattice solve, in one
# dimension-generic pair: the leading grid axis (y in 2d, z in 3d) is
# cut into D slabs of rows_loc rows.  Shard i's halo'd grid holds
# global vertex rows i*rows_loc - 1 .. (i+1)*rows_loc (local rows
# 0 .. rows_loc+1) and global cell rows i*rows_loc - 1 .. (i+1)*rows_loc
# - 1 (local rows 0 .. rows_loc); the stencil reaches one row, so the
# local output rows 1 .. rows_loc see both of their cell rows and every
# X neighbour and are complete.  Rows outside the lattice (shard 0's
# lower halo, the pad rows past G0) are zero in J and X.
#
# A process holds its shards' rows of X: the whole lattice in one
# process, rows [first*rows_loc, ...) up to the lattice's end on W ranks
# (the mesh's `first` and `n_local`).  The rows of another process reach
# it in two halo rows, one exchange per product (`halo_rows`).
#
# The plain version writes that out per shard: a halo'd X per shard and
# the unsharded plain product per shard.  The CUDA kernel does it in one
# launch: each CTA reads its shard's slab of the carrier and its X rows
# from the process's X, the rows of the neighbour processes from the
# halo rows, skips the cells outside the lattice as the unsharded kernel
# does and sums each output vertex in the same order, so on the card it
# equals the unsharded kernel bit for bit, and a process's rows equal the
# same rows of the one-process product.  The TPU's (8, 128) tile padding
# (``:162``, ``:196``) is not carried over; the carrier's innermost cell
# extent is padded to a multiple of 4 values instead, the 16-byte rows
# that the kernel's TMA copies need.

CARRIER_ALIGN = 4
_FLOAT_TYPES = frozenset((torch.float32, torch.float64))


def _carrier_width(gcx):
    """The carrier's innermost cell extent: gcx padded to a multiple of
    CARRIER_ALIGN values."""
    return -(-gcx // CARRIER_ALIGN) * CARRIER_ALIGN


def pad_jac_sharded(jac, lo_r, hi_r, lo_c, hi_c, mesh, rows_loc=None):
    """The stacked per-shard J carrier of the block rows [lo_r, hi_r),
    columns [lo_c, hi_c), built once per Newton solve.  jac (R, C, GC0,
    *rest) holds this process's cell rows: the whole lattice's in one
    process, on W ranks the cell rows from first*rows_loc (whose
    rows_loc, the lattice's, the caller passes).  Returns one contiguous
    (D_local, hi_r-lo_r, hi_c-lo_c, rows_loc+1, *rest) tensor with the
    innermost extent padded by `_carrier_width`: shard i's slab JP[i]
    holds at local cell row 0 the previous shard's last cell row (zero
    on shard 0), at rows 1..rows_loc the shard's own; rows past the
    lattice and the pad columns are zero.  The halo row travels i -> i+1
    by `ppermute_rows` (across a rank boundary, from the rank below), as
    the JAX wrapper's one ``ppermute`` at prepare time."""
    from ..parallel.sharding import ppermute_rows
    if jac.device != mesh.device:
        raise ValueError(f"jac on {jac.device}, shards on {mesh.device}")
    blk = jac[lo_r:hi_r, lo_c:hi_c]
    gc0, gcx = blk.shape[2], blk.shape[-1]
    rl = mesh.rows_loc(gc0 + 1) if rows_loc is None else rows_loc
    D = mesh.n_local
    JP = blk.new_zeros((D,) + blk.shape[:2] + (rl + 1,) + blk.shape[3:-1]
                       + (_carrier_width(gcx),))
    for i in range(D):
        n = max(0, min(rl, gc0 - i * rl))
        JP[i, :, :, 1:1 + n, ..., :gcx] = blk[:, :, i * rl:i * rl + n]
    ppermute_rows([JP[i, :, :, rl:] for i in range(D)], 1,
                  [JP[i, :, :, :1] for i in range(D)], mesh)
    return JP


def check_sharded(JP, X, k, mesh):
    """Validate a sharded product: X (k, G0, *rest), this process's rows
    of the lattice, and the carrier JP of `pad_jac_sharded` on the
    mesh's device, f32 or f64 of one dtype, both contiguous, JP shaped
    (D_local, 2**dim*k, 2**dim*k, rows_loc+1, *cellrest) with the padded
    innermost extent.  In one process X holds the whole lattice; on W
    ranks rows_loc is the carrier's, and X holds at most the rank's
    D_local * rows_loc rows, all of them unless the lattice ends on the
    rank (the last)."""
    dim = X.dim() - 1
    if not (JP.device == X.device == mesh.device):
        raise ValueError(f"carrier on {JP.device}, X on {X.device}, shards "
                         f"on {mesh.device}")
    if X.dtype not in _FLOAT_TYPES or JP.dtype != X.dtype:
        raise TypeError(f"stencil_matvec_sharded takes f32 or f64 of one "
                        f"dtype, got carrier {JP.dtype}, X {X.dtype}")
    if dim not in (2, 3) or k not in (1, dim) or X.shape[0] != k:
        raise ValueError(f"k={k} does not fit X {tuple(X.shape)}")
    if not (JP.is_contiguous() and X.is_contiguous()):
        raise ValueError("stencil_matvec_sharded needs a contiguous carrier "
                         "and X")
    kl = 2 ** dim * k
    shape = X.shape
    if mesh.world > 1:
        rl = JP.shape[3] - 1
        full = mesh.n_local * rl
        last = mesh.rank == mesh.world - 1
        if not (0 < shape[1] <= full and (last or shape[1] == full)):
            raise ValueError(f"rank {mesh.rank} holds {shape[1]} rows of X, "
                             f"its {mesh.n_local} shards {full}")
    else:
        rl = mesh.rows_loc(shape[1])
    want = ((mesh.n_local, kl, kl, rl + 1)
            + tuple(g - 1 for g in shape[2:-1])
            + (_carrier_width(shape[-1] - 1),))
    if JP.shape != want:
        raise ValueError(f"carrier {tuple(JP.shape)} does not fit X "
                         f"{tuple(X.shape)} with k={k} on {mesh.n_shards} "
                         f"shards: want {want}")


def halo_rows(X, mesh):
    """The rows next to this process's rows of X, from the neighbour
    ranks in one exchange: (row below, row above), each (k, 1, *rest),
    None at the lattice's ends (and in one process)."""
    if mesh.world == 1:
        return None, None
    from ..parallel import dist
    spec = ((X.shape[0], 1) + tuple(X.shape[2:]), X.dtype)
    below = mesh.rank > 0
    above = mesh.rank < mesh.world - 1
    return dist.exchange_rows(
        mesh.ranks, down=X[:, :1] if below else None,
        up=X[:, -1:] if above else None,
        from_below=spec if below else None,
        from_above=spec if above else None)


def stencil_matvec_sharded_reference(JP, X, k, mesh, halo=None):
    """Plain version of `stencil_matvec_sharded`, per shard: the halo'd
    X_loc (k, rows_loc+2, *rest) of every shard of this process, cut
    from its rows of X with the halo rows of the neighbour processes
    (`halo`, or one exchange; zero at the lattice's ends), the unsharded
    plain product of JP[i] (pad columns dropped) and X_loc per shard,
    its rows 1..rows_loc kept, the shards concatenated and cut back to
    X's rows."""
    check_sharded(JP, X, k, mesh)
    D = mesh.n_local
    nx = X.shape[1]
    rl = JP.shape[3] - 1
    gcx = X.shape[-1] - 1
    kl = JP.shape[1]
    lo, hi = halo_rows(X, mesh) if halo is None else halo
    zero = X.new_zeros((k, 1) + X.shape[2:])
    Xe = torch.cat([zero if lo is None else lo, X,
                    X.new_zeros((k, D * rl - nx) + X.shape[2:]),
                    zero if hi is None else hi], dim=1)
    # a contiguous slab (a copy only where there are pad columns), so
    # the einsum blocks its sums as for an unpadded per-shard block
    ys = [stencil_matvec_reference(JP[i, ..., :gcx].contiguous(),
                                   Xe[:, i * rl:i * rl + rl + 2], 0, kl, 0,
                                   kl, k, k)[:, 1:rl + 1]
          for i in range(D)]
    return torch.cat(ys, dim=1)[:, :nx]


def stencil_matvec_sharded(JP, X, k, mesh, halo=None):
    """Y = J_block X on a row-slab sharded lattice: X (k, G0, *rest),
    this process's rows (`check_sharded`); JP from `pad_jac_sharded`.
    CPU tensors use the plain version; CUDA tensors launch the 2d or 3d
    sharded kernel once for all shards of this process, after one
    exchange of the halo rows with the neighbour ranks (W > 1), and each
    launch adds one to `stencil_matvec_sharded.launches`.  `halo`, the
    pair `halo_rows` returns, skips the exchange: the seam lattice
    passes the halo rows it has spread where its seam straddles a rank
    boundary (`solvers/lattice.py::_sharded_op`), and chip_smoke.py's
    timing of a rank's product passes them so that its clock sees the
    kernel alone."""
    check_sharded(JP, X, k, mesh)
    if X.device.type == "cpu":
        if halo is None:
            return stencil_matvec_sharded_reference(JP, X, k, mesh)
        return stencil_matvec_sharded_reference(JP, X, k, mesh, halo)
    if X.device.type != "cuda":
        raise ValueError(f"the sharded stencil kernel takes CUDA tensors, "
                         f"got {X.device}")
    dim = X.dim() - 1
    lib = (kernels.lattice_stencil_sharded() if dim == 2
           else kernels.lattice_stencil3d_sharded())
    fn = lib.f32 if X.dtype == torch.float32 else lib.f64
    rl = JP.shape[3] - 1
    nx = X.shape[1]
    lo, hi = halo_rows(X, mesh) if halo is None else halo
    row0 = mesh.first * rl
    g0 = row0 + nx + (hi is not None)     # the lattice's end as seen here
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(JP.data_ptr(), X.data_ptr(),
                 0 if lo is None else lo.data_ptr(),
                 0 if hi is None else hi.data_ptr(), Y.data_ptr(),
                 mesh.n_local, rl, row0, nx, g0, *X.shape[2:], JP.shape[-1],
                 k, stream)
    if err != 0:
        raise RuntimeError(f"{lib.name} launch failed: error {err}")
    stencil_matvec_sharded.launches += 1
    return Y


stencil_matvec_sharded.launches = 0
