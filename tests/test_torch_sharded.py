"""The row-slab sharded pieces of the PyTorch port against the JAX
package, on the CPU (the per-shard products use the plain version):

(a) `stencil_matvec_sharded` (with `pad_jac_sharded`) against JAX's
    `pad_jac_sharded`/`stencil_matvec_sharded` and their 3d siblings,
    whose Pallas kernels run in interpret mode under shard_map on the
    8-device CPU mesh, at the sizes of tests/test_pallas_stencil.py
    where the pad rows cross shards (2d 43x37, 3d 11x13x19); the port
    runs D = 8 and D = 3.  f32: rtol 1e-5, atol 1e-4 (that file's
    bounds).
(b) the port's sharded product against its unsharded plain product for
    D in {1, 2, 3, 8}, and on a 10-row lattice where whole shards own
    only pad rows (D in {6, 8}): rtol 1e-6 in f32, 1e-14 in f64 (the
    per-shard einsums may block their sums differently by shape).
(c) the gather-free lattice residual and element matrices against JAX
    (`lattice_residual`, `_prepare64_lat` on row-padded state) in 2d
    and 3d, f64, rel 1e-12.
Plus the stacked carrier's layout, the shared validation of a sharded
product (which the CUDA path runs too) and the layout helpers of
parallel/sharding.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import meshio
from cracks_tpu.mesh import Forest
from cracks_tpu.ops import pallas_stencil as ps
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.parallel.sharding import make_device_mesh
from cracks_tpu.solvers import lattice as jlat
from cracks_tpu_torch import interop
from cracks_tpu_torch.ops import stencil
from cracks_tpu_torch.parallel import sharding
from cracks_tpu_torch.solvers import lattice

torch.set_num_threads(1)
CPU = torch.device("cpu")
# dim -> (vertex grid, the two square blocks (k, lo, hi))
CASES = {2: ((43, 37), [(2, 0, 8), (1, 8, 12)]),
         3: ((11, 13, 19), [(3, 0, 24), (1, 24, 32)])}


def _mesh(D):
    return sharding.make_shard_mesh([CPU] * D)


def _inputs(seed, dim, k, dtype=np.float32):
    grid = CASES[dim][0]
    ndl = 2 ** dim * (dim + 1)
    rng = np.random.default_rng(seed)
    jac = rng.normal(size=(ndl, ndl) + tuple(g - 1 for g in grid))
    X = rng.normal(size=(k,) + grid)
    return jac.astype(dtype), X.astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_sharded(dim, k, lo, hi):
    """JAX's sharded wrapper (interpret mode, 8-way mesh): inputs and
    output as numpy."""
    jac, X = _inputs(dim + k, dim, k)
    mesh = make_device_mesh(8)
    ax = mesh.axis_names[0]
    grid = CASES[dim][0]
    gp = -(-grid[0] // 8) * 8
    J, Xj = jnp.asarray(jac[lo:hi, lo:hi]), jnp.asarray(X)
    if dim == 2:
        JPs = ps.pad_jac_sharded(J, mesh=mesh, axis=ax, gyp=gp, ty=16, tx=16)
        y = ps.stencil_matvec_sharded(JPs, Xj, k=k, GY=grid[0], GX=grid[1],
                                      mesh=mesh, axis=ax, gyp=gp, ty=16,
                                      tx=16, interpret=True)
    else:
        JPs = ps.pad_jac3d_sharded(J, mesh=mesh, axis=ax, gzp=gp, tz=2,
                                   ty=8, tx=16)
        y = ps.stencil_matvec3d_sharded(JPs, Xj, k=k, GZ=grid[0],
                                        GY=grid[1], GX=grid[2], mesh=mesh,
                                        axis=ax, gzp=gp, tz=2, ty=8, tx=16,
                                        interpret=True)
    return jac, X, np.asarray(y)


@pytest.mark.parametrize("D", [8, 3])
@pytest.mark.parametrize("dim,k,lo,hi", [(2, 2, 0, 8), (2, 1, 8, 12),
                                         (3, 3, 0, 24), (3, 1, 24, 32)])
def test_sharded_matches_jax_sharded_interpret(dim, k, lo, hi, D):
    jac, X, ref = _jax_sharded(dim, k, lo, hi)
    J, Xt = interop.lattice_arrays(jac, X, device=CPU)
    mesh = _mesh(D)
    before = stencil.stencil_matvec_sharded.launches
    y = stencil.stencil_matvec_sharded(
        stencil.pad_jac_sharded(J, lo, hi, lo, hi, mesh), Xt, k, mesh)
    assert y.dtype == torch.float32 and tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-4)
    # CPU tensors take the plain version: no kernel launch is counted
    assert stencil.stencil_matvec_sharded.launches == before


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-14)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_matches_unsharded_plain(dim, dtype, rtol, D):
    mesh = _mesh(D)
    for k, lo, hi in CASES[dim][1]:
        jac, X = (torch.as_tensor(a) for a in _inputs(7, dim, k, dtype))
        JP = stencil.pad_jac_sharded(jac, lo, hi, lo, hi, mesh)
        rl = mesh.rows_loc(X.shape[1])
        gcx = jac.shape[-1]
        assert JP.is_contiguous() and tuple(JP.shape) == (
            (D, hi - lo, hi - lo, rl + 1) + tuple(jac.shape[3:-1])
            + (-(-gcx // 4) * 4,))
        y = stencil.stencil_matvec_sharded(JP, X, k, mesh)
        ref = stencil.stencil_matvec_reference(jac, X, lo, hi, lo, hi, k, k)
        assert y.dtype == ref.dtype and y.shape == ref.shape
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("D", [6, 8])
@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_with_pad_only_shards_matches_unsharded_plain(dim, D):
    """G0 = 10 rows: rows_loc 2, so shards 5.. own only pad rows."""
    grid = (10, 13) if dim == 2 else (10, 5, 7)
    mesh = _mesh(D)
    assert mesh.rows_loc(10) == 2 and (D - 1) * 2 >= 10
    rng = np.random.default_rng(11)
    ndl = 2 ** dim * (dim + 1)
    jac = torch.as_tensor(rng.normal(size=(ndl, ndl) + tuple(
        g - 1 for g in grid)))
    for k, lo, hi in CASES[dim][1]:
        X = torch.as_tensor(rng.normal(size=(k,) + grid))
        JP = stencil.pad_jac_sharded(jac, lo, hi, lo, hi, mesh)
        assert not JP[5:].any()
        y = stencil.stencil_matvec_sharded(JP, X, k, mesh)
        ref = stencil.stencil_matvec_reference(jac, X, lo, hi, lo, hi, k, k)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-14,
                                   atol=0)


@pytest.mark.parametrize("rest", [(3,), (2, 5)], ids=["2d", "3d"])
def test_pad_jac_sharded_layout(rest):
    """One contiguous (D, kl, kl, rows_loc+1, *rest) carrier, the
    innermost extent padded to a multiple of 4 with zeros: in slab i,
    local cell row 0 is the previous shard's last cell row (zero on
    shard 0); rows past the lattice are zero."""
    G0, GC0 = 43, 42
    jac = torch.arange(2 * 2 * GC0 * int(np.prod(rest)),
                       dtype=torch.float64).reshape(2, 2, GC0, *rest) + 1.0
    mesh = _mesh(8)                    # gyp 48, 6 rows per shard
    assert (mesh.padded(G0), mesh.rows_loc(G0)) == (48, 6)
    JP = stencil.pad_jac_sharded(jac, 0, 2, 0, 2, mesh)
    assert JP.is_contiguous()
    assert tuple(JP.shape) == (8, 2, 2, 7) + rest[:-1] + (-(-rest[-1] // 4) * 4,)
    assert not JP[..., rest[-1]:].any()
    for i in range(8):
        for r in range(7):
            g = i * 6 - 1 + r           # global cell row of local row r
            want = (jac[:, :, g] if 0 <= g < GC0
                    else torch.zeros((2, 2) + rest, dtype=torch.float64))
            torch.testing.assert_close(JP[i, :, :, r, ..., :rest[-1]], want,
                                       rtol=0, atol=0)


def test_sharded_validation_raises_on_cpu():
    """`check_sharded`, which the CUDA path runs before its launch too,
    refuses a carrier whose rows, width, k or device do not fit X or the
    mesh, a dtype other than f32/f64 and a non-contiguous X."""
    mesh = _mesh(4)
    jac = torch.zeros((12, 12, 40, 36))
    X = torch.zeros((2, 41, 37))
    JP = stencil.pad_jac_sharded(jac, 0, 8, 0, 8, mesh)
    stencil.check_sharded(JP, X, 2, mesh)
    bad = {
        "rows": (stencil.pad_jac_sharded(jac, 0, 8, 0, 8, _mesh(3)), X, 2,
                 mesh),
        "width": (JP[..., :-4].contiguous(), X, 2, mesh),
        "k": (JP, X[:1].contiguous(), 1, mesh),
        "block": (stencil.pad_jac_sharded(jac, 8, 12, 8, 12, mesh), X, 2,
                  mesh),
        "device": (JP.to("meta"), X, 2, mesh),
        "mesh device": (JP, X, 2, sharding.ShardMesh(4, torch.device(
            "meta"))),
        "non-contiguous X": (JP, X.transpose(1, 2).contiguous()
                             .transpose(1, 2), 2, mesh),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            stencil.stencil_matvec_sharded(*args)
    for dt in (torch.float16, torch.int32):
        with pytest.raises(TypeError):
            stencil.stencil_matvec_sharded(JP.to(dt), X.to(dt), 2, mesh)
    with pytest.raises(TypeError):
        stencil.stencil_matvec_sharded(JP, X.double(), 2, mesh)


def test_ppermute_rows_and_row_padding():
    slabs = [torch.full((1, 1, 2), float(i + 1)) for i in range(4)]
    up = [torch.full((1, 1, 2), -1.0) for _ in range(4)]
    down = [torch.full((1, 1, 2), -1.0) for _ in range(4)]
    sharding.ppermute_rows(slabs, 1, up)
    sharding.ppermute_rows(slabs, -1, down)
    assert [float(h[0, 0, 0]) for h in up] == [0.0, 1.0, 2.0, 3.0]
    assert [float(h[0, 0, 0]) for h in down] == [2.0, 3.0, 4.0, 0.0]
    with pytest.raises(ValueError):
        sharding.ppermute_rows(slabs, 2, up)
    X = torch.arange(2 * 5 * 3, dtype=torch.float64).reshape(2, 5, 3)
    Xp = sharding.pad_rows(X, 8)
    assert tuple(Xp.shape) == (2, 8, 3) and not Xp[:, 5:].any()
    assert torch.equal(sharding.unpad_rows(Xp, 5), X)
    assert sharding.pad_rows(X, 5) is X
    assert sharding.make_shard_mesh([CPU] * 4).padded(641) == 644


@functools.lru_cache(maxsize=None)
def _lattice_problem(dim):
    """A non-square lattice with random f64 state, the JAX raster cell
    arrays and scalars."""
    if dim == 2:
        f = Forest(meshio.rect_mesh([-10, -10], [10, 10], [10, 8]))
        f.refine_global(2)
    else:
        f = Forest(meshio.rect_mesh([-1, -1, -1], [1, 1, 1], [3, 4, 5]))
        f.refine_global(1)
    mesh = f.extract()
    lay = jlat.detect_tensor_grid(mesh)
    rng = np.random.default_rng(dim)
    grid = lay.grid
    vp = jnp.asarray(lay.vert_pos)
    n_v = mesh.n_vertices
    state = [jlat._to_lat(jnp.asarray(rng.standard_normal(n_v * dim)), vp,
                          grid, dim)]
    state += [jlat._to_lat(jnp.asarray(rng.uniform(0, 1, n_v)), vp, grid, 1)
              for _ in range(3)]
    caL = jlat.permuted_cell_arrays(mesh, 0.463, 0.417, lay,
                                    dtype=jnp.float64, chunk=False)
    sc = jphysics.make_scalars(
        pressure=1e-3, constant_k=1e-3, alpha_eps=0.1, G_c=1.0,
        gamma_dt=2.0, theta=2.0, use_old_pf=0.0, decompose_rhs=0.0)
    return grid, state, caL, sc


def _port(dim):
    grid, state, caL, sc = _lattice_problem(dim)
    return (interop.cell_arrays(caL, device=CPU),
            interop.scalars(sc, device=CPU))


@pytest.mark.parametrize("dim", [2, 3])
def test_lattice_residual_matches_jax(dim):
    grid, state, caL, sc = _lattice_problem(dim)
    RU_j, RP_j = jlat.lattice_residual(*state, caL, sc, dim=dim,
                                       with_split=False, monolithic=False)
    caL_t, sc_t = _port(dim)
    RU, RP = lattice.lattice_residual(
        *interop.lattice_arrays(*state, device=CPU), caL_t, sc_t, dim=dim,
        with_split=False, monolithic=False)
    for a, b in ((RU, RU_j), (RP, RP_j)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_element_matrices_lattice_matches_jax(dim):
    """JAX's `_prepare64_lat` and the port's `_prepare64` on the same
    row-padded state (gyp for D = 8), handed over as numpy."""
    grid, state, caL, sc = _lattice_problem(dim)
    gyp = -(-grid[0] // 8) * 8
    padded = [jlat._pad_rows(X, gyp) for X in state]
    ref = np.asarray(jlat._prepare64_lat(
        *padded, caL, sc, grid=grid, dim=dim, with_split=False,
        monolithic=False))
    caL_t, sc_t = _port(dim)
    U, P, P_old, P_oold = interop.lattice_arrays(*padded, device=CPU)
    assert U.shape[1] == gyp > grid[0]
    jac = lattice._prepare64(U, P, P_old, P_oold, caL_t, sc_t, grid=grid,
                             dim=dim, with_split=False, monolithic=False)
    assert jac.dtype == torch.float64 and tuple(jac.shape) == ref.shape
    np.testing.assert_allclose(jac.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
