"""The port's own copies of the numpy host modules (configuration, coarse
meshes, the forest with its native key core, problem definitions, the
Kelly estimator, VTU/PVD output) and its constraint handling, against
the JAX package's originals on the 2d and 3d Sneddon forests (10 roots
per axis, refine 1; Kelly and output also with a refined box, i.e.
hanging vertices).  The copies must
agree exactly: vertex identity, Dirichlet masks and parameters are
integer or bit-for-bit data."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import config as jconfig, meshio as jmeshio
from cracks_tpu import kelly as jkelly, output as joutput
from cracks_tpu import problems as jproblems
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.ops import constraints as jcon
from cracks_tpu_torch import (config, kelly, mesh, meshio, native, output,
                              problems)
from cracks_tpu_torch.ops import constraints

torch.set_num_threads(1)

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params")
MESH_FIELDS = ("cell2vert", "vert_coords", "cell_coords", "cell_level",
               "cell_root", "diameters", "vertex_keys", "hang_child",
               "hang_masters", "hang_weights", "bface_cell", "bface_face",
               "bface_id")


def _prm(dim):
    return os.path.join(PARAMS, f"parameters_sneddon_{dim}d.prm")


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def forests(request):
    dim = request.param
    args = ([-10] * dim, [10] * dim, [10] * dim)
    fj = JForest(jmeshio.rect_mesh(*args))
    ft = mesh.Forest(meshio.rect_mesh(*args))
    fj.refine_global(1)
    ft.refine_global(1)
    return dim, fj, ft, fj.extract(), ft.extract()


def _closure_points(forest):
    """All half-grid closure points of the active cells: every key kind
    (cell corners, edge/face midpoints, interiors)."""
    dim = forest.dim
    W = (forest.S >> forest.level).astype(np.int64)
    offs = np.array(np.meshgrid(*([np.array([0, 1, 2])] * dim),
                                indexing="ij")).reshape(dim, -1).T
    pts = (forest.anchor[:, None, :]
           + offs[None, :, :] * (W[:, None, None] // 2)).reshape(-1, dim)
    return np.repeat(forest.root, len(offs)), pts


def test_mesh_matches_jax(forests):
    dim, _, _, mj, mt = forests
    assert mt.dim == mj.dim == dim
    assert mt.n_cells == 20 ** dim
    for name in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name),
                                      err_msg=name)
    assert sorted(mt.boundary_vertices) == sorted(mj.boundary_vertices)
    assert len(mt.boundary_vertices) == 2 * dim
    for b, v in mj.boundary_vertices.items():
        np.testing.assert_array_equal(mt.boundary_vertices[b], v)


def test_native_keys_match_jax_and_numpy(forests, monkeypatch):
    """The port's native core (built into cracks_tpu_torch/build/) and
    its numpy fallback give the JAX package's keys bit for bit."""
    _, fj, ft, _, _ = forests
    roots, pts = _closure_points(ft)
    assert native.get_lib() is not None, "no C++ compiler for forest.cpp"
    k_native = ft.canonical_keys(roots, pts)
    k_jax = fj.canonical_keys(roots, pts)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    k_numpy = ft.canonical_keys(roots, pts)
    np.testing.assert_array_equal(k_native, k_jax)
    np.testing.assert_array_equal(k_numpy, k_jax)


@pytest.mark.parametrize("dim", [2, 3])
def test_load_parameters_matches_jax(dim):
    pj = jconfig.load_parameters(_prm(dim))
    pt = config.load_parameters(_prm(dim))
    assert pt.dimension == pj.dimension == dim
    assert config.dump_parameters(pt) == jconfig.dump_parameters(pj)
    for h in (0.5, 0.125):
        assert pt.k_reg(h) == pj.k_reg(h)
        assert pt.eps_reg(h) == pj.eps_reg(h)
    assert pt.pressure(time=2.0) == pj.pressure(time=2.0)
    over = dict(n_global_pre_refine=3, max_no_timesteps=1, cg_rtol=1e-8)
    assert (config.dump_parameters(config.load_parameters(_prm(dim), **over))
            == jconfig.dump_parameters(jconfig.load_parameters(_prm(dim),
                                                               **over)))


def test_dirichlet_and_initial_values_match_jax(forests):
    dim, _, _, mj, mt = forests
    pj = jconfig.load_parameters(_prm(dim))
    pt = config.load_parameters(_prm(dim))
    for initial in (True, False):
        ref = jproblems.dirichlet_conditions(pj, mj, 1.0, initial_step=initial)
        got = problems.dirichlet_conditions(pt, mt, 1.0, initial_step=initial)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    mask_u = got[0]
    if dim == 3:
        # the all-faces clamp: exactly the boundary vertices, every
        # component (cracks.cc:2686-2694)
        bnd = np.zeros(mt.n_vertices, bool)
        for v in mt.boundary_vertices.values():
            bnd[v] = True
        np.testing.assert_array_equal(mask_u, np.repeat(bnd[:, None], 3, 1))
    h = mt.min_cell_diameter
    for a, b in zip(problems.initial_values(pt, mt, h),
                    jproblems.initial_values(pj, mj, h)):
        np.testing.assert_array_equal(a, b)


def test_constraints_match_jax(forests):
    """make_constraints, condense_residual and expand_update on the
    Sneddon Dirichlet masks with a random active set."""
    dim, _, _, mj, mt = forests
    pt = config.load_parameters(_prm(dim))
    mask_u, _, mask_p, _ = problems.dirichlet_conditions(
        pt, mt, 0.0, initial_step=False)
    con_j = jcon.make_constraints(mj, mask_u, mask_p)
    con_t = constraints.make_constraints(mt, mask_u, mask_p,
                                         dtype=torch.float64,
                                         device=torch.device("cpu"))
    for name in jcon.Constraints._fields:
        np.testing.assert_array_equal(getattr(con_t, name).numpy(),
                                      np.asarray(getattr(con_j, name)),
                                      err_msg=name)
    rng = np.random.default_rng(4)
    n_v = mt.n_vertices
    ru, rp = rng.normal(size=n_v * dim), rng.normal(size=n_v)
    active = rng.uniform(size=n_v) < 0.1
    t = lambda a: torch.as_tensor(a)
    for fj, ft in ((jcon.condense_residual, constraints.condense_residual),
                   (jcon.expand_update, constraints.expand_update)):
        ref = fj(jnp.asarray(ru), jnp.asarray(rp), con_j,
                 jnp.asarray(active))
        got = ft(t(ru), t(rp), con_t, t(active))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(con_t.dirichlet_u.sum()) == int(mask_u.sum()) > 0


@pytest.mark.parametrize("kind", ["uniform", "hanging"])
def test_kelly_and_output_match_jax(forests, kind, tmp_path):
    """kelly_estimate equal bit for bit, and write_vtu / PvdWriter
    writing the same bytes, on the refine-1 mesh and on a copy with the
    cells near the origin refined once more (hanging vertices)."""
    dim, fj, ft, mj, mt = forests
    if kind == "hanging":
        args = ([-10] * dim, [10] * dim, [10] * dim)
        fj, ft = JForest(jmeshio.rect_mesh(*args)), mesh.Forest(
            meshio.rect_mesh(*args))
        mj, mt = fj.extract(), ft.extract()
        flags = np.all(np.abs(mt.cell_coords.mean(axis=1)) < 4, axis=1)
        mj, _, _ = fj.refine_and_transfer(flags, mj, [np.zeros(mj.n_vertices)])
        mt, _, _ = ft.refine_and_transfer(flags, mt, [np.zeros(mt.n_vertices)])
        assert len(mt.hang_child) > 0
    rng = np.random.default_rng(dim)
    u = rng.normal(size=mt.n_vertices * dim)
    eta = kelly.kelly_estimate(mt, u)
    assert eta.shape == (mt.n_cells,) and eta.max() > 0
    np.testing.assert_array_equal(eta, jkelly.kelly_estimate(mj, u))

    point = {"displacement": u.reshape(-1, dim),
             "phasefield": rng.uniform(size=mt.n_vertices)}
    cell = {"level": mt.cell_level.astype(float)}
    for pkg, m, sub in ((output, mt, "port"), (joutput, mj, "jax")):
        d = tmp_path / sub
        d.mkdir()
        pkg.write_vtu(str(d / "solution_00000.vtu"), m, point, cell)
        pvd = pkg.PvdWriter(str(d))
        pvd.add(1.0, "solution_00000.vtu")
        pvd.add(2.0, "solution_00001.vtu")
    for name in ("solution_00000.vtu", "solution.pvd", "solution.visit"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
