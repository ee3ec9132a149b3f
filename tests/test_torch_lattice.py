"""The lattice GMG solve of the PyTorch port against the JAX package's
split lattice solve (cracks_tpu/solvers/lattice.py), on Sneddon 2d
(refine 3, 81x81 vertices) and 3d (refine 1, 21^3 vertices) lattices:
layout and hierarchy, transfer operators, the Galerkin coarse chain,
the per-level smoother data, one V-cycle, and one whole Newton-system
solve.  f32 results are compared at tolerances stated per test (the two
frameworks sum f32 terms in different orders)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu import meshio, problems
from cracks_tpu.config import Parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.mesh import Forest
from cracks_tpu_torch import interop, mesh as tmesh, meshio as tmeshio
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.solvers import lattice

torch.set_num_threads(1)
CPU = torch.device("cpu")


# dim -> (refinement of the Newton-system fixture, its GMG levels)
CASES = {2: (3, 4), 3: (1, 3)}


def _params(refine, dim=2):
    return Parameters(
        dimension=dim, test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
        poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
        eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
        max_no_newton_steps=50, max_no_line_search_steps=10,
        n_global_pre_refine=refine, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=0, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
        mixed_precision_cg=True)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("dim,refine,grid,n_levels", [
    (2, 3, (81, 81), 4), (3, 3, (81, 81, 81), 5)], ids=["2d", "3d"])
def test_layout_and_hierarchy_match_jax(dim, refine, grid, n_levels):
    """3d at refine 3: the 2,125,764-DoF bench lattice, 5 GMG levels down
    to 6^3 vertices."""
    f = Forest(meshio.rect_mesh([-10] * dim, [10] * dim, [10] * dim))
    f.refine_global(refine)
    mesh = f.extract()
    p = _params(refine, dim)

    def dirichlet_fn(m):
        mu_, _, mp_, _ = problems.dirichlet_conditions(p, m, 0.0,
                                                       initial_step=False)
        return mu_, mp_

    lay_j = jlat.detect_tensor_grid(mesh)
    lay = lattice.detect_tensor_grid(mesh)
    assert lay.grid == lay_j.grid == grid
    for name in ("vert_idx", "vert_pos", "cell_perm"):
        np.testing.assert_array_equal(getattr(lay, name),
                                      getattr(lay_j, name))
    hier_j = jlat.build_lattice_hierarchy(mesh, lay_j, dirichlet_fn)
    hier = lattice.build_lattice_hierarchy(mesh, lay, dirichlet_fn,
                                           device=CPU)
    assert hier.n_levels == hier_j.n_levels == n_levels
    np.testing.assert_array_equal(_np(hier.vert_pos), _np(hier_j.vert_pos))
    for a, b in zip(hier.dir_u + hier.dir_p, hier_j.dir_u + hier_j.dir_p):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(hier.P_embed), _np(hier_j.P_embed))
    if dim == 3:
        assert tuple(hier.dir_u[0].shape) == (3, 6, 6, 6)
        return
    # the seam-glued slit mesh: the same layout and seam; at refine 2
    # the seam cannot coarsen above 50 vertices, so neither package
    # builds a hierarchy (the Galerkin GMG then takes it), at refine 3
    # both build 2 levels (tests/test_torch_seam.py holds the finer
    # ones)
    fs = tmesh.Forest(tmeshio.read_ucd(
        os.path.join(tmeshio.MESH_DIR, "unit_slit.inp"), dim=2))
    fs.refine_global(2)
    for n_levels_s in (None, 2):
        ms = fs.extract()
        lay_s = jlat.detect_tensor_grid(ms)
        lay_t = lattice.detect_tensor_grid(ms)
        assert lay_s.seam is not None and tuple(lay_t.seam) == lay_s.seam
        for name in ("grid", "vert_idx", "vert_pos", "cell_perm"):
            np.testing.assert_array_equal(getattr(lay_t, name),
                                          getattr(lay_s, name))
        hj = jlat.build_lattice_hierarchy(ms, lay_s, dirichlet_fn)
        ht = lattice.build_lattice_hierarchy(ms, lay_t, dirichlet_fn,
                                             device=CPU)
        if n_levels_s is None:
            assert hj is None and ht is None
        else:
            assert ht.n_levels == hj.n_levels == n_levels_s
            assert tuple(ht.seam) == hj.seam
        fs.refine_global(1)


@pytest.mark.parametrize("grid_c,grid_f", [((9, 9), (17, 17)),
                                           ((11, 6), (21, 11)),
                                           ((5, 6, 4), (9, 11, 7))])
def test_prolong_restrict_transpose_and_match_jax(grid_c, grid_f):
    rng = np.random.default_rng(1)
    for k in (1, len(grid_f)):
        Xc = rng.normal(size=(k,) + grid_c)
        Yf = rng.normal(size=(k,) + grid_f)
        P = lattice.prolong(torch.as_tensor(Xc), grid_f, k)
        R = lattice.restrict(torch.as_tensor(Yf), k)
        lhs = float(torch.sum(P * torch.as_tensor(Yf)))
        rhs = float(torch.sum(torch.as_tensor(Xc) * R))
        assert abs(lhs - rhs) < 1e-10 * (abs(lhs) + 1)
        np.testing.assert_allclose(
            _np(P), _np(jlat.prolong(jnp.asarray(Xc), grid_f, k)),
            rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(
            _np(R), _np(jlat.restrict(jnp.asarray(Yf), k)),
            rtol=1e-14, atol=1e-14)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def newton_system(request):
    """A Sneddon state after one JAX load step (CASES), the JAX system,
    the same system in the port, and the operators both build from
    it."""
    dim = request.param
    refine = CASES[dim][0]
    sim_j = JSimulation(_params(refine, dim), verbose=False)
    state = sim_j.run()
    sys_j = sim_j.sys
    sim = Simulation(_params(refine, dim), device=CPU, verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    sim._set_context()
    sys_t = sim.sys
    sys_t.scalars = interop.scalars(sys_j.scalars, device=CPU)
    active = np.asarray(state.active_mask, dtype=bool)
    st_j = (state.u, state.phi, state.phi_old, state.phi_oold)
    st_t = interop.solution_state(*st_j, active, device=CPU)
    hier_j = sys_j.lattice_hierarchy
    jacL64_j = jlat._prepare64(*st_j, sys_j.lattice_ca64, sys_j.scalars,
                               grid=hier_j.grid, dim=dim, with_split=False,
                               monolithic=False)
    return dict(dim=dim, sys_j=sys_j, sys_t=sys_t, st_j=st_j, st_t=st_t,
                active=active, jacL64_j=jacL64_j, hier_j=hier_j)


def test_prepare64_and_coarsen_chain_match_jax(newton_system):
    ns = newton_system
    hier = ns["sys_t"].lattice_hierarchy
    dim = ns["dim"]
    lat = [lattice._to_lat(x, hier.vert_pos, hier.grid, k)
           for x, k in zip(ns["st_t"][:4], (dim, 1, 1, 1))]
    jac64 = lattice._prepare64(*lat, ns["sys_t"].lattice_ca64,
                               ns["sys_t"].scalars, grid=hier.grid,
                               dim=dim, with_split=False, monolithic=False)
    ref64 = np.asarray(ns["jacL64_j"])
    np.testing.assert_allclose(_np(jac64), ref64, rtol=1e-12,
                               atol=1e-12 * np.abs(ref64).max())
    jacs_j = jlat._prepare32_from64(ns["jacL64_j"], ns["hier_j"].P_embed,
                                    n_levels=ns["hier_j"].n_levels)
    jacs = lattice._prepare32_from64(torch.tensor(ref64), hier.P_embed,
                                     n_levels=hier.n_levels)
    assert len(jacs) == len(jacs_j) == CASES[ns["dim"]][1]
    for a, b in zip(jacs, jacs_j):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def _levels_both(ns, which, sharp):
    hier_j = ns["hier_j"]
    jacs_j = jlat._prepare32_from64(ns["jacL64_j"], hier_j.P_embed,
                                    n_levels=hier_j.n_levels)
    jacs_t = [torch.tensor(np.asarray(j)) for j in jacs_j]
    k, lo, hi = lattice._blk(which, ns["dim"])
    grid = hier_j.grid
    act_j = jnp.zeros(int(np.prod(grid)), bool).at[hier_j.vert_pos].set(
        jnp.asarray(ns["active"])).reshape((1,) + grid)
    lv_j = jlat._build_block_levels(list(jacs_j), hier_j.dir_u, hier_j.dir_p,
                                    grid, act_j, lo, hi, k, which,
                                    sharp=sharp)
    hier = ns["sys_t"].lattice_hierarchy
    act_t = lattice._active_lattice(ns["st_t"][4], hier.vert_pos, grid)
    lv_t = lattice._build_block_levels(jacs_t, hier.dir_u, hier.dir_p, grid,
                                       act_t, lo, hi, k, which, sharp=sharp)
    return lv_j, lv_t


@pytest.mark.parametrize("sharp", [False, True])
@pytest.mark.parametrize("which", ["u", "p"])
def test_block_levels_match_jax(newton_system, which, sharp):
    lv_j, lv_t = _levels_both(newton_system, which, sharp)
    for a, b in zip(lv_t, lv_j):
        np.testing.assert_array_equal(_np(a.free), _np(b.free))
        np.testing.assert_allclose(_np(a.Dinv), _np(b.Dinv), rtol=1e-6)
        # Gershgorin is a max of f32 sums; Lanczos a 10-step f32 Ritz
        # value whose rounding path differs between the frameworks
        np.testing.assert_allclose(float(a.lam), float(b.lam),
                                   rtol=1e-4 if sharp else 1e-5)
        assert float(a.rng) == float(b.rng) == (4.0 if sharp else 20.0)


@pytest.mark.parametrize("which", ["u", "p"])
def test_vcycle_matches_jax(newton_system, which):
    ns = newton_system
    hier_j = ns["hier_j"]
    jacs_j = jlat._prepare32_from64(ns["jacL64_j"], hier_j.P_embed,
                                    n_levels=hier_j.n_levels)
    grid = hier_j.grid
    levels_j, coarse_j, _ = jlat._prepare_levels(
        jacs_j, hier_j.dir_u, hier_j.dir_p, hier_j.vert_pos,
        jnp.asarray(ns["active"]), grid=grid, which=which, dim=ns["dim"],
        sharp=False)
    k, lo, hi = lattice._blk(which, ns["dim"])
    M_j = jlat.make_vcycle(list(levels_j), lo, hi, k, degree=2,
                           coarse_factor=coarse_j)
    hier = ns["sys_t"].lattice_hierarchy
    jacs_t = tuple(torch.tensor(np.asarray(j)) for j in jacs_j)
    levels_t, coarse_t, fine_pad = lattice._prepare_levels(
        jacs_t, hier.dir_u, hier.dir_p,
        lattice._active_lattice(ns["st_t"][4], hier.vert_pos, grid),
        grid=grid, which=which, dim=ns["dim"], sharp=False)
    assert fine_pad is None
    M_t = lattice.make_vcycle(levels_t, lo, hi, k, coarse_t)
    b = np.random.default_rng(5).normal(size=(k,) + grid).astype(np.float32)
    ref = np.asarray(M_j(jnp.asarray(b)))
    got = _np(M_t(torch.as_tensor(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_solve_lattice_matches_jax_split_solve(newton_system):
    ns = newton_system
    sys_j, sys_t = ns["sys_j"], ns["sys_t"]
    n_v = sys_t.mesh.n_vertices
    rng = np.random.default_rng(0)
    rhs_u = rng.normal(size=n_v * ns["dim"])
    rhs_p = rng.normal(size=n_v)
    sys_j._split_jac_cache = None
    sys_j._split_levels_cache = None
    u, phi, phi_old, phi_oold = ns["st_j"]
    du_j, dp_j, its_j = jlat._solve_split(
        sys_j, sys_j.lattice_hierarchy, u, phi, phi_old, phi_oold,
        sys_j.constraints(1.0), jnp.asarray(ns["active"]),
        jnp.asarray(rhs_u), jnp.asarray(rhs_p), False)
    ut, pt, pot, poot, act = ns["st_t"]
    du, dp, its = lattice.solve_lattice(
        sys_t, ut, pt, pot, poot, act, torch.as_tensor(rhs_u),
        torch.as_tensor(rhs_p), False)
    for a, b in ((du, du_j), (dp, dp_j)):
        b = np.asarray(b)
        rel = np.linalg.norm(_np(a) - b) / np.linalg.norm(b)
        assert rel <= 1e-6, rel
    assert abs(its - its_j) <= 0.1 * its_j, (its, its_j)
    # a repeated solve at the same context reuses the cached operators
    jacs = sys_t._split_jac_cache[2]
    du2, _, _ = lattice.solve_lattice(
        sys_t, ut, pt, pot, poot, act, torch.as_tensor(rhs_u),
        torch.as_tensor(rhs_p), False)
    assert sys_t._split_jac_cache[2] is jacs
    torch.testing.assert_close(du2, du, rtol=0, atol=0)
