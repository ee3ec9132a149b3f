"""The port's linear solves against the JAX package's, on the same
Newton systems: a 2d and a 3d Sneddon mesh with hanging nodes (a box of
refined cells in a coarse grid), a seeded state and a nonempty active
set, inputs made with numpy and given to both packages.

- the dense direct solve (`solvers/linear.solve_direct`): rel 1e-12,
  the singular-factor RuntimeError on both sides, and the Newton
  solve's fall-through from it to the Krylov path;
- the stored-element-matrix block CG (`solvers/assembled.
  solve_cg_block`) in f64: the same iteration count, updates within
  rel 1e-10;
- the mixed-precision refinement loop (`newton._solve_assembled`):
  updates within rel 1e-5 (the field tolerance of
  tests/test_assembled.py), iteration counts within 2 %: the f32
  passes of the two packages round differently, so a pass may take one
  iteration more or less;
- the router: a jacobi run on a uniform mesh takes the assembled path,
  gmg on a hanging-node mesh the Galerkin hierarchy."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import config as jconfig, meshio as jmeshio
from cracks_tpu.driver import System as JSystem
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.solvers import assembled as jassembled
from cracks_tpu.solvers import linear as jlinear
from cracks_tpu.solvers import newton as jnewton
from cracks_tpu_torch import config, meshio, mesh
from cracks_tpu_torch.driver import Simulation, System
from cracks_tpu_torch.solvers import assembled, linear, newton

torch.set_num_threads(1)

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params")
# coarse roots per axis: 2d 10 x 10 (about 1,000 DoFs after the box is
# refined), 3d 4 x 4 x 4 (892 DoFs, 72 hanging vertices)
ROOTS = {2: 10, 3: 4}


def _prm(dim):
    return os.path.join(PARAMS, f"parameters_sneddon_{dim}d.prm")


def _hanging_mesh(forest_cls, rect_mesh, dim):
    """The coarse Sneddon box with the cells whose centre lies within 6
    of the origin refined once: a 2:1 mesh with hanging vertices."""
    forest = forest_cls(rect_mesh([-10] * dim, [10] * dim, [ROOTS[dim]] * dim))
    coarse = forest.extract()
    flags = np.all(np.abs(coarse.cell_coords.mean(axis=1)) < 6, axis=1)
    m, _, _ = forest.refine_and_transfer(flags, coarse,
                                         [np.zeros(coarse.n_vertices)])
    return m


def _context(sys_, p, h):
    sys_.constant_k = p.k_reg(h)
    sys_.alpha_eps = p.eps_reg(h)
    sys_.set_context(time=1.0, timestep=1.0, old_timestep=1.0,
                     old_old_timestep=1.0, use_old_timestep_pf=False,
                     timestep_number=1)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def case(request):
    """Both packages' Systems on the same hanging mesh, plus seeded
    numpy inputs: state, active set (no hanging vertex), and a
    right-hand side zero on the constrained dofs."""
    dim = request.param
    mj = _hanging_mesh(JForest, jmeshio.rect_mesh, dim)
    mt = _hanging_mesh(mesh.Forest, meshio.rect_mesh, dim)
    assert mj.n_dofs == mt.n_dofs and len(mt.hang_child) > 0
    out = dict(dim=dim, mesh=mt)
    for mixed in (False, True):
        pj = jconfig.load_parameters(_prm(dim), mixed_precision_cg=mixed)
        pt = config.load_parameters(_prm(dim), mixed_precision_cg=mixed)
        sj, st = JSystem(pj, mj, None), System(pt, mt, device="cpu")
        for s in (sj, st):
            _context(s, pj, mj.min_cell_diameter)
        out["mixed" if mixed else "f64"] = (sj, st)
    rng = np.random.default_rng(dim)
    n_v = mt.n_vertices
    phi = rng.uniform(0.2, 1.0, n_v)
    state = (rng.normal(scale=1e-3, size=n_v * dim), phi,
             np.minimum(1.0, phi + 0.05), np.minimum(1.0, phi + 0.05))
    active = (rng.uniform(size=n_v) < 0.1) & ~mt.hanging_mask()
    assert active.any()
    con = out["f64"][1].constraints(0.0)
    free_u = ~(con.dirichlet_u | con.hang_mask_u).numpy()
    free_p = ~(con.dirichlet_p | con.hang_mask_p).numpy() & ~active
    out.update(state=state, active=active,
               rhs=(rng.normal(size=n_v * dim) * free_u,
                    rng.normal(size=n_v) * free_p))
    return out


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _rel(a, b):
    """max |a - b| over max |b| (0 for two zero vectors)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_solve_direct_matches_jax(case):
    sj, st = case["f64"]
    dim = case["dim"]
    kw = dict(dim=dim, with_split=False, monolithic=False)
    args = case["state"]
    du_j, dp_j, _ = jlinear.solve_direct(
        *_jax(*args), sj.ca, sj.scalars, sj.constraints(0.0),
        *_jax(case["active"], *case["rhs"]), **kw)
    du, dp, its = linear.solve_direct(
        *_torch(*args), st.ca, st.scalars, st.constraints(0.0),
        *_torch(case["active"], *case["rhs"]), **kw)
    assert its == 1
    assert _rel(du, du_j) <= 1e-12 and _rel(dp, dp_j) <= 1e-12
    # constraints distributed: zero on Dirichlet dofs, hanging children
    # interpolated from their masters
    con = st.constraints(0.0)
    assert torch.all(du[con.dirichlet_u] == 0)
    assert torch.all(dp[torch.as_tensor(case["active"])] == 0)
    child = con.hang_child_p
    torch.testing.assert_close(
        dp[child], (con.hang_weights * dp[con.hang_masters_p]).sum(1),
        rtol=1e-14, atol=1e-300)


def test_singular_factor_raises_on_both_sides(case):
    """K reg = 0 with the phase field 0 everywhere degrades the
    displacement block to exactly zero: an exactly singular factor,
    which both packages refuse with RuntimeError (the Newton then falls
    through to the Krylov path)."""
    sj, st = case["f64"]
    dim = case["dim"]
    kw = dict(dim=dim, with_split=False, monolithic=False)
    u, phi = case["state"][0], np.zeros_like(case["state"][1])
    sc_j = sj.scalars._replace(constant_k=jnp.asarray(0.0))
    sc_t = st.scalars._replace(constant_k=torch.tensor(0.0,
                                                       dtype=torch.float64))
    with pytest.raises(RuntimeError, match="singular"):
        jlinear.solve_direct(*_jax(u, phi, phi, phi), sj.ca, sc_j,
                             sj.constraints(0.0),
                             *_jax(case["active"], *case["rhs"]), **kw)
    with pytest.raises(RuntimeError, match="singular"):
        linear.solve_direct(*_torch(u, phi, phi, phi), st.ca, sc_t,
                            st.constraints(0.0),
                            *_torch(case["active"], *case["rhs"]), **kw)


def test_singular_factor_falls_through_to_the_krylov_path(case):
    """With the same exactly singular system, both packages' Newton
    solve (`newton._solve`, linear_solver = auto at this size) falls
    through to the stored-matrix Jacobi CG: the same iteration count
    and the same update."""
    sj, st = case["f64"]
    u, phi = case["state"][0], np.zeros_like(case["state"][1])
    saved = sj.scalars, st.scalars
    sj.scalars = sj.scalars._replace(constant_k=jnp.asarray(0.0))
    st.scalars = st.scalars._replace(
        constant_k=torch.tensor(0.0, dtype=torch.float64))
    try:
        du_j, dp_j, its_j = jnewton._solve(
            sj, *_jax(u, phi, phi, phi), sj.constraints(0.0),
            *_jax(case["active"], *case["rhs"]), False)
        du, dp, its = newton._solve(
            st, *_torch(u, phi, phi, phi), st.constraints(0.0),
            *_torch(case["active"], *case["rhs"]), False)
    finally:
        sj.scalars, st.scalars = saved
    assert its == int(its_j) > 1
    assert _rel(du, du_j) <= 1e-10 and _rel(dp, dp_j) <= 1e-10


def test_solve_cg_block_matches_jax(case):
    """f64 stored-matrix block CG on the same system: the JAX element
    matrices differ from the port's by rounding only, and the two CGs
    take the same number of iterations."""
    sj, st = case["f64"]
    dim = case["dim"]
    kw = dict(dim=dim, with_split=False, monolithic=False)
    n_ud, n_v = case["mesh"].n_vertices * dim, case["mesh"].n_vertices
    jac_j = jassembled.build_jacobians(*_jax(*case["state"]), sj.ca,
                                       sj.scalars, **kw)
    d_u, d_p = jassembled.diagonals(jac_j, sj.ca, n_ud, n_v, dim=dim)
    du_j, dp_j, its_j = jassembled.solve_cg_block(
        jac_j, sj.ca, sj.constraints(0.0), *_jax(case["active"],
                                                 *case["rhs"]),
        d_u, d_p, 1e-12, 1e-300, dim=dim, maxiter=2000, chunk=100)
    jac = assembled.build_jacobians(*_torch(*case["state"]), st.ca,
                                    st.scalars, **kw)
    assert _rel(jac, jac_j) <= 1e-12
    cs = st.cell_scatter
    d_u, d_p = assembled.diagonals(jac, st.ca, cs, dim=dim)
    du, dp, its = assembled.solve_cg_block(
        jac, st.ca, st.constraints(0.0), *_torch(case["active"],
                                                 *case["rhs"]),
        d_u, d_p, 1e-12, 1e-300, cs, dim=dim, maxiter=2000,
        stall_window=100)
    assert its == int(its_j) and its > 10
    assert _rel(du, du_j) <= 1e-10 and _rel(dp, dp_j) <= 1e-10


def test_mixed_refinement_loop_matches_jax(case):
    sj, st = case["mixed"]
    assert st.ca32.JxW.dtype == torch.float32
    rhs = case["rhs"]
    du_j, dp_j, its_j = jnewton._solve_assembled(
        sj, *_jax(*case["state"]), sj.constraints(0.0),
        *_jax(case["active"], *rhs), False)
    du, dp, its = newton._solve_assembled(
        st, *_torch(*case["state"]), st.constraints(0.0),
        *_torch(case["active"], *rhs), False)
    assert abs(its - int(its_j)) <= 0.02 * int(its_j), (its, its_j)
    assert _rel(du, du_j) <= 1e-5 and _rel(dp, dp_j) <= 1e-5


PRM_2D = _prm(2)


def test_jacobi_on_a_uniform_mesh_takes_the_assembled_path(monkeypatch):
    """As in the JAX package, the lattice hierarchy exists only under
    gmg: a jacobi CG run on a uniform lattice goes through the
    stored-element-matrix solve."""
    calls = []
    orig = newton._solve_assembled

    def spy(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(newton, "_solve_assembled", spy)
    p = config.load_parameters(
        PRM_2D, n_global_pre_refine=1, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=0, output_dir="",
        linear_solver="cg", preconditioner="jacobi", cg_rtol=1e-8,
        mixed_precision_cg=True)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.sys.lattice_hierarchy is None
    assert newton.check_linear_solver(sim.sys) == "assembled"
    assert len(calls) == sim.solver_effort[0][1] > 0
    assert sim.step_cuts == 0


def test_gmg_on_a_hanging_node_mesh_raises_a10():
    """Formerly a refusal naming A10; A10 is ported now, so gmg on a
    hanging-node mesh takes the Galerkin hierarchy (the split solve with
    mixed precision), as in the JAX package."""
    p = config.load_parameters(
        PRM_2D, n_global_pre_refine=0, n_local_pre_refine=1,
        n_refinement_cycles=0, max_no_timesteps=0, output_dir="",
        linear_solver="cg", preconditioner="gmg", mixed_precision_cg=True)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert len(sim.mesh.hang_child) > 0
    assert sim.sys.galerkin_hierarchy is not None
    assert newton.check_linear_solver(sim.sys) == "galerkin"
    assert sim.step_cuts == 0 and sim.solver_effort[0][2] > 0
