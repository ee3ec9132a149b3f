"""The owned+ghost halo pool (cracks_tpu_torch/parallel/halo.py and the
pooled condensation of solvers/halo_newton.py) against the JAX package:

- `build_halo_partition` on a 2d and a 3d hanging-node mesh for D in
  {1, 3, 8}: every integer array equal, every float array to rel 1e-15
  (both copy one host recipe), the redistribution round trip, owned
  slots tiling the vertices once;
- the ghost read and the combine against their definitions;
- the pooled residual at D = 8, with and without the Miehe split,
  against JAX's ``halo_residual_fn`` on the 8 virtual CPU devices and
  against the port's flat residual (rel 1e-12), on a partition with pad
  cells, which stay finite and add exactly zero;
- the heads' condensed residual against the flat hanging-node
  condensation (rel 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import mesh as jmesh, meshio as jmeshio
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.parallel import halo as jhalo
from cracks_tpu.parallel.sharding import make_device_mesh
from cracks_tpu_torch import mesh as tmesh, meshio as tmeshio
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.ops.constraints import (hanging_interpolate_p,
                                              hanging_interpolate_u,
                                              hanging_transpose_p,
                                              hanging_transpose_u,
                                              make_constraints)
from cracks_tpu_torch.ops.scatter import cell_scatter
from cracks_tpu_torch.parallel import halo
from cracks_tpu_torch.solvers.halo_newton import build_halo_heads

torch.set_num_threads(1)
CPU = torch.device("cpu")
LAM, MU = 0.463, 0.417
SCALARS = dict(pressure=1e-3, constant_k=1e-3, alpha_eps=0.1, G_c=1.0,
               gamma_dt=0.0, theta=2.0, use_old_pf=0.0, decompose_rhs=1.0)


def _mesh(Forest, rect_mesh, dim):
    """The hanging-node meshes: in 2d the JAX package's pooled-
    condensation mesh (tests/test_halo_newton.py:73-82: 4 x 4 cells,
    refined once, a corner patch again), in 3d 2^3 cells refined once
    and a corner patch again (2:1 balanced)."""
    forest = Forest(rect_mesh([0] * dim, [1] * dim, [4 if dim == 2 else 2] * dim))
    forest.refine_global(1)
    flags = np.zeros(forest.n_cells, bool)
    centers = forest.extract().cell_coords.mean(axis=1)
    flags[(centers < 0.4).all(axis=1)] = True
    forest.execute_refinement(forest.balance_flags(flags))
    return forest.extract()


@pytest.fixture(scope="module")
def meshes():
    out = {}
    for dim in (2, 3):
        m = _mesh(tmesh.Forest, tmeshio.rect_mesh, dim)
        mj = _mesh(jmesh.Forest, jmeshio.rect_mesh, dim)
        assert np.array_equal(m.cell2vert, mj.cell2vert)
        assert len(m.hang_child) > 0
        out[dim] = m
    return out


def _state(mesh, seed=0):
    rng = np.random.default_rng(seed)
    n_v = mesh.n_vertices
    return (rng.standard_normal(n_v * mesh.dim) * 1e-3,
            rng.uniform(0.3, 1.0, n_v), rng.uniform(0.3, 1.0, n_v))


def _t(a):
    return torch.as_tensor(np.asarray(a), device=CPU)


_CA = physics.CellArrays._fields


def _per_shard_cells(part):
    """JAX's per-shard cell tables (D, ..., C) from the port's flattened
    ones, the shard offsets taken off the gathers."""
    D, n_loc, dim = part.n_shards, part.n_loc, part.dim
    shard = torch.arange(D)[:, None, None]
    per = lambda a: a.reshape(a.shape[:-1] + (D, -1)).movedim(-2, 0)
    ca = part.ca
    return dict(gather_u=per(ca.gather_u) - shard * n_loc * dim,
                gather_p=per(ca.gather_p) - shard * n_loc,
                JxW=per(ca.JxW), grads=per(ca.grads), shape_v=ca.shape_v,
                lam=per(ca.lam), mu=per(ca.mu), inv_diam2=per(ca.inv_diam2))


@pytest.mark.parametrize("dim,D", [(2, 1), (2, 3), (2, 8), (3, 1), (3, 3),
                                   (3, 8)])
def test_partition_matches_jax(meshes, dim, D):
    mesh = meshes[dim]
    ours = halo.build_halo_partition(mesh, LAM, MU, D, device=CPU)
    ref = jhalo.build_halo_partition(mesh, LAM, MU, D)
    assert ((ours.n_loc, ours.n_pool, ours.n_shards, ours.dim,
             ours.n_vertices)
            == (ref.n_loc, ref.n_pool, ref.n_shards, ref.dim,
                ref.n_vertices))
    arrays = {**ours.arrays._asdict(), **_per_shard_cells(ours)}
    for name, a in arrays.items():
        a = a.numpy()
        b = np.asarray(getattr(ref.arrays.ca if name in _CA else ref.arrays,
                               name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0,
                                       err_msg=name)
        else:
            assert a.shape == b.shape and np.array_equal(a, b), name
    # the owned slots tile the vertex set exactly once; the round trip
    own = ours.arrays.own_mask_p
    assert np.array_equal(np.sort(ours.arrays.loc2glob[own].numpy()),
                          np.arange(mesh.n_vertices))
    if D > 1:
        assert ours.n_loc < mesh.n_vertices
    u, phi, _ = _state(mesh)
    ul, pl = halo.global_to_local_u(ours, _t(u)), halo.global_to_local_p(
        ours, _t(phi))
    np.testing.assert_array_equal(ul.numpy(),
                                  jhalo.global_to_local_u(ref, u))
    np.testing.assert_array_equal(pl.numpy(),
                                  jhalo.global_to_local_p(ref, phi))
    np.testing.assert_array_equal(halo.local_to_global_u(ours, ul).numpy(), u)
    np.testing.assert_array_equal(halo.local_to_global_p(ours, pl).numpy(),
                                  phi)


def test_ghost_read_and_combine(meshes):
    """A ghost read of an owner-canonical vector fills every ghost with
    its owner's value; a combine of per-shard partial sums gives each
    owner the global sum and zeroes every other slot."""
    mesh = meshes[2]
    part = halo.build_halo_partition(mesh, LAM, MU, 8, device=CPU)
    gr_u, gr_p, cb_u, cb_p = halo.make_halo_ops(part)
    u, phi, _ = _state(mesh)
    arr = part.arrays
    canon = lambda x, comps: torch.where(
        arr.own_mask_p.repeat_interleave(comps, dim=1), x, 0.0)
    ul, pl = halo.global_to_local_u(part, _t(u)), halo.global_to_local_p(
        part, _t(phi))
    assert torch.equal(gr_u(canon(ul, 2)), ul)
    assert torch.equal(gr_p(canon(pl, 1)), pl)
    # partial sums: every shard holds a random share of each of its
    # slots' values; the combine must total them
    rng = np.random.default_rng(1)
    share = _t(rng.uniform(size=tuple(pl.shape)))
    real = arr.loc2glob < part.n_vertices
    parts = torch.where(real, share, 0.0)
    totals = np.zeros(mesh.n_vertices)
    np.add.at(totals, arr.loc2glob[real].numpy(), parts[real].numpy())
    out = cb_p(parts)
    np.testing.assert_allclose(
        out[arr.own_mask_p].numpy(), totals[arr.loc2glob[arr.own_mask_p]],
        rtol=1e-15)
    assert not out[~arr.own_mask_p].any()
    ou = cb_u(parts.repeat_interleave(2, dim=1))
    np.testing.assert_array_equal(ou.reshape(8, -1, 2)[..., 1].numpy(),
                                  out.numpy())


@pytest.mark.parametrize("with_split", [False, True],
                         ids=["no-split", "split"])
def test_halo_residual_matches_jax(meshes, with_split):
    """D = 8 on the 2d hanging-node mesh (pad cells in the partition):
    the pooled residual equals JAX's halo_residual_fn and the port's
    flat residual to rel 1e-12."""
    mesh = meshes[2]
    part = halo.build_halo_partition(mesh, LAM, MU, 8, device=CPU)
    assert part.ca.JxW.shape[-1] > mesh.n_cells
    u, phi, phi_old = _state(mesh)
    sc = physics.make_scalars(**SCALARS, dtype=torch.float64, device=CPU)
    fn = halo.halo_residual_fn(part, with_split=with_split)
    loc = lambda x, f: f(part, _t(x))
    ru_l, rp_l = fn(loc(u, halo.global_to_local_u),
                    loc(phi, halo.global_to_local_p),
                    loc(phi_old, halo.global_to_local_p),
                    loc(phi_old, halo.global_to_local_p), sc)
    assert torch.isfinite(ru_l).all() and torch.isfinite(rp_l).all()
    ru = halo.local_to_global_u(part, ru_l).numpy()
    rp = halo.local_to_global_p(part, rp_l).numpy()

    dmesh = make_device_mesh(8)
    jpart = jhalo.device_put_partition(
        jhalo.build_halo_partition(mesh, LAM, MU, 8), dmesh)
    jfn = jhalo.halo_residual_fn(dmesh, jpart, with_split=with_split,
                                 monolithic=False)
    jl = lambda x, f: jnp.asarray(f(jpart, x))
    ju_l, jp_l = jfn(jl(u, jhalo.global_to_local_u),
                     jl(phi, jhalo.global_to_local_p),
                     jl(phi_old, jhalo.global_to_local_p),
                     jl(phi_old, jhalo.global_to_local_p),
                     jphysics.make_scalars(**SCALARS))
    ju = jhalo.local_to_global_u(jpart, np.asarray(ju_l))
    jp = jhalo.local_to_global_p(jpart, np.asarray(jp_l))

    ca = physics.cell_arrays_from_core(
        physics.build_cell_core(mesh, LAM, MU, device=CPU), torch.float64)
    cs = cell_scatter(ca, mesh.n_vertices * 2, mesh.n_vertices)
    fu, fp = physics.assemble_residual(
        _t(u), _t(phi), _t(phi_old), _t(phi_old), ca, sc, cs, dim=2,
        with_split=with_split, monolithic=False)
    for got, want in ((ru, ju), (rp, jp), (ru, fu.numpy()),
                      (rp, fp.numpy())):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("with_split", [False, True],
                         ids=["no-split", "split"])
def test_condensed_residual_matches_flat(meshes, with_split):
    """The heads' pooled residual (ghost read, H, assembly, H^T, owner
    combine) equals the flat condensation (H, assembly, H^T) to rel
    1e-12, and its norm the flat norm; the element matrices of the pad
    cells are exactly zero and every matrix finite."""
    mesh = meshes[2]
    part = halo.build_halo_partition(mesh, LAM, MU, 8, device=CPU)
    u, phi, phi_old = _state(mesh, seed=2)
    sc = physics.make_scalars(**SCALARS, dtype=torch.float64, device=CPU)
    n_v = mesh.n_vertices
    ia, _, _ = build_halo_heads(part, with_split=with_split, max_steps=5)
    U = halo.global_to_local_u(part, _t(u))
    Ph = halo.global_to_local_p(part, _t(phi))
    Po = halo.global_to_local_p(part, _t(phi_old))
    none = torch.zeros_like(Ph, dtype=torch.bool)
    tot_p, pde_u, _, res = ia(U, Ph, Po, Po, none.repeat_interleave(2, 1),
                              none, sc)
    con = make_constraints(mesh, np.zeros((n_v, 2), bool),
                           np.zeros(n_v, bool), dtype=torch.float64,
                           device=CPU)
    ca = physics.cell_arrays_from_core(
        physics.build_cell_core(mesh, LAM, MU, device=CPU), torch.float64)
    cs = cell_scatter(ca, n_v * 2, n_v)
    # the flat state is H-consistent (the pool interpolates every field)
    po = hanging_interpolate_p(_t(phi_old), con)
    ru, rp = physics.assemble_residual(
        hanging_interpolate_u(_t(u), con), hanging_interpolate_p(_t(phi), con),
        po, po, ca, sc, cs, dim=2, with_split=with_split, monolithic=False)
    tu_ref = hanging_transpose_u(ru, con).numpy()
    tp_ref = hanging_transpose_p(rp, con).numpy()
    tu = halo.local_to_global_u(part, pde_u).numpy()
    tp = halo.local_to_global_p(part, tot_p).numpy()
    np.testing.assert_allclose(tu, tu_ref, rtol=0,
                               atol=1e-12 * np.abs(tu_ref).max())
    np.testing.assert_allclose(tp, tp_ref, rtol=0,
                               atol=1e-12 * np.abs(tp_ref).max())
    # the hanging rows are not free: the flat norm without them
    free_u = ~con.hang_mask_u.numpy()
    free_p = ~con.hang_mask_p.numpy()
    ref_norm = np.sqrt((tu_ref[free_u] ** 2).sum()
                       + (tp_ref[free_p] ** 2).sum())
    assert float(res) == pytest.approx(ref_norm, rel=1e-12)
    # the pad cells (JxW = 0, grads = 0, gathering from the trash slot)
    flat = lambda x: x.reshape(-1)
    jac = physics.element_matrices(flat(U), flat(Ph), flat(Po), flat(Po),
                                   part.ca, sc, dim=2,
                                   with_split=with_split, monolithic=False)
    pad = (part.ca.JxW == 0).all(dim=0)
    assert pad.any() and torch.isfinite(jac).all()
    assert not jac[..., pad].any()
