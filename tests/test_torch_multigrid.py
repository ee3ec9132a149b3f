"""The geometric GMG of the PyTorch port's matrix-free operator
(`preconditioner = gmg` with `assembled_matvec = False`;
cracks_tpu_torch/solvers/multigrid.py and linear.solve_cg_gmg) against
the JAX package's (cracks_tpu/solvers/multigrid.py, linear.py), in f64
on the CPU:

- `build_hierarchy` on Sneddon 2d refine 2 (two levels below the fine
  mesh) and on a Sneddon mesh with one local pre-refinement (hanging
  nodes): the same levels, injections, gathers, constraint bundles,
  prolongation masters and weights, bit for bit;
- `solve_cg_gmg` on a seeded Newton system of Sneddon 2d refine 2:
  equal iterations, the update within rel 1e-9;
- the elasticity case of tests/test_multigrid.py (phi = 1), at refine 2:
  fewer than a third of the Jacobi CG's iterations;
- the driver on `miehe_tension_adaptive_1`, step 0 under gmg (the slit
  mesh, three geometric levels; the matrix-free V-cycle costs hundreds
  of small operations per jvp on the CPU, so the Sneddon file, whose
  degraded crack strip takes the geometric GMG over a thousand
  iterations per load step, is the card's, chip_smoke.py phase 18):
  statistics within rel 1e-8, equal Newton iterations, linear
  iterations within 2 per Newton solve."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import problems as jproblems
from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.ops.constraints import condense_residual as jcondense
from cracks_tpu.solvers import linear as jlinear, multigrid as jmg
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.ops.constraints import condense_residual
from cracks_tpu_torch.solvers import linear, newton

from .test_torch_galerkin import _context, _jax_side, _prerefined

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNEDDON = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
TENSION = os.path.join(ROOT, "params", "tests",
                       "miehe_tension_adaptive_1.prm")
GEOMETRIC = dict(n_local_pre_refine=0, n_refinement_cycles=0,
                 linear_solver="cg", preconditioner="gmg",
                 assembled_matvec=False)
MESHES = {
    "sneddon_2d_r2": dict(GEOMETRIC, n_global_pre_refine=2),
    "sneddon_2d_local": dict(GEOMETRIC, n_global_pre_refine=1,
                             n_local_pre_refine=1),
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _both(over):
    """The port's Simulation (its System and geometric hierarchy built)
    and the JAX package's forest, mesh, System and geometric hierarchy
    on the same cells, with the same context."""
    sim = _prerefined(SNEDDON, **over)
    jf, jm, js, _ = _jax_side(sim, SNEDDON, **over)
    jp = js.params

    def dirichlet_fn(m):
        mu_, _, mp_, _ = jproblems.dirichlet_conditions(jp, m, 0.0,
                                                        initial_step=False)
        return mu_, mp_

    jhier = jmg.build_hierarchy(
        jf, jm, jp, lambda m: jproblems.cell_lame_fields(jp, m, None),
        dirichlet_fn)
    _context(js, sim.sys, k=sim.constant_k, eps=sim.alpha_eps)
    return sim, js, jhier


@pytest.mark.parametrize("name", list(MESHES))
def test_hierarchy_matches_jax(name):
    sim, js, jhier = _both(MESHES[name])
    hier = sim.sys.hierarchy
    assert sim.sys.galerkin_hierarchy is None
    assert sim.sys.lattice_hierarchy is None
    assert newton.check_linear_solver(sim.sys) == "geometric"
    assert len(hier.levels) == len(jhier.levels) >= 1
    if name == "sneddon_2d_local":
        assert len(sim.mesh.hang_child) > 0
    else:
        assert len(hier.levels) == 2
    for lv, jl in zip(hier.levels, jhier.levels):
        for f in ("inject_p", "inject_u", "masters_p", "weights_p",
                  "masters_u", "weights_u"):
            a, b = getattr(lv, f), getattr(jl, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
        for f in ("gather_u", "gather_p", "JxW", "grads", "lam", "mu",
                  "inv_diam2"):
            np.testing.assert_array_equal(_np(getattr(lv.ca, f)),
                                          _np(getattr(jl.ca, f)), err_msg=f)
        for f in jl.con._fields:
            np.testing.assert_array_equal(_np(getattr(lv.con, f)),
                                          _np(getattr(jl.con, f)),
                                          err_msg=f)
        assert lv.cs.n_p == len(_np(jl.inject_p))
    for f in ("masters_p", "weights_p", "masters_u", "weights_u"):
        np.testing.assert_array_equal(_np(getattr(hier, f)),
                                      _np(getattr(jhier, f)), err_msg=f)


def _system(sim, js, state, active, rhs):
    """Both packages' argument lists of solve_cg_gmg / solve_cg_block on
    one Newton system (numpy state, active set and rhs)."""
    con_j = js.constraints(0.0)
    jargs = ([jnp.asarray(a) for a in state], js.ca, js.scalars, con_j,
             jnp.asarray(active), [jnp.asarray(r) for r in rhs])
    s = sim.sys
    targs = ([torch.as_tensor(a) for a in state], s.ca, s.scalars,
             s.cell_scatter, s.constraints(0.0), torch.as_tensor(active),
             [torch.as_tensor(r) for r in rhs])
    return jargs, targs


def test_solve_cg_gmg_matches_jax():
    sim, js, jhier = _both(MESHES["sneddon_2d_r2"])
    rng = np.random.default_rng(7)
    n_v = sim.mesh.n_vertices
    phi = rng.uniform(0.2, 1.0, n_v)
    state = (rng.normal(scale=1e-3, size=n_v * 2), phi,
             np.minimum(1.0, phi + 0.05), np.minimum(1.0, phi + 0.05))
    active = rng.uniform(size=n_v) < 0.05
    kw = dict(dim=2, with_split=False, monolithic=False)
    con_j = js.constraints(0.0)
    ru, rp = jphysics.assemble_residual(*(jnp.asarray(a) for a in state),
                                        js.ca, js.scalars, **kw)
    rhs = [_np(r) for r in jcondense(ru, rp, con_j, jnp.asarray(active))]
    (st_j, ca_j, sc_j, con_j, act_j, rhs_j), (st, ca, sc, cs, con, act,
                                              rhs_t) = _system(
        sim, js, state, active, rhs)
    du_j, dp_j, it_j = jlinear.solve_cg_gmg(
        *st_j, ca_j, sc_j, con_j, act_j, *rhs_j, jhier, 1e-8, 1e-300,
        maxiter=3000, **kw)
    du, dp, its = linear.solve_cg_gmg(
        *st, ca, sc, cs, con, act, *rhs_t, sim.sys.hierarchy, 1e-8, 1e-300,
        maxiter=3000, **kw)
    assert its == int(it_j) > 5
    assert _rel(du, du_j) <= 1e-9 and _rel(dp, dp_j) <= 1e-9


def test_gmg_beats_jacobi_on_elasticity():
    """tests/test_multigrid.py's case (there at refine 3): the
    undegraded operator (phi = 1) at Sneddon refine 2, a seeded rhs on
    the free u dofs."""
    sim = _prerefined(SNEDDON, **MESHES["sneddon_2d_r2"])
    s = sim.sys
    s.constant_k, s.alpha_eps = sim.constant_k, sim.alpha_eps
    s.set_context(time=1.0, timestep=1.0, old_timestep=1.0,
                  old_old_timestep=1.0, use_old_timestep_pf=False,
                  timestep_number=0)
    n_v = sim.mesh.n_vertices
    ones = torch.ones(n_v, dtype=torch.float64)
    state = (torch.zeros(n_v * 2, dtype=torch.float64), ones, ones, ones)
    active = torch.zeros(n_v, dtype=torch.bool)
    con = s.constraints(0.0)
    rng = np.random.default_rng(0)
    rhs = condense_residual(torch.as_tensor(rng.normal(size=n_v * 2)),
                            torch.zeros(n_v, dtype=torch.float64), con,
                            active)
    kw = dict(dim=2, with_split=False, monolithic=False)
    _, _, it_g = linear.solve_cg_gmg(
        *state, s.ca, s.scalars, s.cell_scatter, con, active, *rhs,
        s.hierarchy, 1e-8, 1e-300, maxiter=2000, **kw)
    diag = physics.jacobi_diagonal_approx(*state, s.ca, s.scalars,
                                          s.cell_scatter, dim=2,
                                          monolithic=False)
    _, _, it_j = linear.solve_cg_block(
        *state, s.ca, s.scalars, s.cell_scatter, con, active, *rhs, *diag,
        1e-8, 1e-300, maxiter=2000, **kw)
    assert 0 < it_g < it_j / 3, (it_g, it_j)


def test_miehe_tension_gmg_matches_jax():
    over = dict(output_dir="", max_no_timesteps=0, linear_solver="cg",
                preconditioner="gmg", assembled_matvec=False)
    sim_j = JSimulation(jload_parameters(TENSION, **over), verbose=False)
    sim_j.run()
    sim = Simulation(config.load_parameters(TENSION, **over), device="cpu",
                     verbose=False)
    sim.run()
    assert newton.check_linear_solver(sim.sys) == "geometric"
    assert len(sim.sys.hierarchy.levels) == 3
    dt, dj = sim.statistics.data, sim_j.statistics.data
    assert dt["DoFs"] == dj["DoFs"]
    for col in ("Bulk Energy", "Crack Energy", "Load y"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    newton_its = [e[1] for e in sim.solver_effort]
    assert newton_its == [e[1] for e in sim_j.solver_effort]
    lin, lin_j = (np.array([e[2] for e in s.solver_effort])
                  for s in (sim, sim_j))
    assert (np.abs(lin - lin_j) <= 2 * np.array(newton_its)).all(), (
        lin, lin_j)
    assert sim.step_cuts == 0
