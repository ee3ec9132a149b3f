"""The penalized monolithic Newton (`outer solver = simple monolithic`,
cracks_tpu_torch/solvers/newton.py::newton_iteration and the driver's
step branch) against the JAX package's, on the CPU, with
tests/test_workloads.py's settings: params/tests/sneddon_2d_1.prm, no
local pre-refinement or refinement cycle, two load steps, gamma 100.

- The dense direct solve (363 DoFs): bulk and crack energy per step
  within rel 1e-10 of the JAX run, equal Newton iterations, the phase
  field in [0, 1].
- cg + gmg + mixed precision at global refinement 1 (1,323 DoFs, a
  uniform lattice with 2 levels: the lattice solve, which builds its
  operators with the monolithic flag, ROADMAP C6) against the JAX split
  solve (``FUSED_SOLVE_MAX_DOFS = 0``): equal Newton and linear
  iterations per step, and the energies within rel 1e-7 (atol 1e-12 of
  each column's largest value: step 1's bulk energy, 2.1e-15, is 10
  orders below step 0's).  The Newton of step 1 creeps (24 iterations,
  each cutting the residual by ~0.97 until the bound 1e-7), so its last
  iterate carries every f32 pass's rounding; the measured differences
  are 2.4e-9 (bulk, step 0) and 3.2e-8 / 3.4e-8 (crack, steps 0 / 1).
- Both operator caches (the lattice and the Galerkin split solves) miss
  when only the monolithic flag differs.
- The gamma schedule (no penalty before step 1) and the step branch:
  a residual reduction above upper_newton_rho cuts the step by 10 and
  solves again with the old phase field; a failed solve cuts and starts
  over."""

import os

import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu.config import load_parameters as jload
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation, SolutionState
from cracks_tpu_torch.solvers import newton
from cracks_tpu_torch.solvers.newton import NewtonLog, NoConvergence

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(ROOT, "params", "tests", "sneddon_2d_1.prm")
SNEDDON = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
# tests/test_workloads.py::test_simple_monolithic_sneddon
MONO = dict(output_dir="", max_no_timesteps=1, n_local_pre_refine=0,
            n_refinement_cycles=0, outer_solver="simple monolithic",
            gamma_penal=100.0)
LATTICE = dict(n_global_pre_refine=1, linear_solver="cg",
               preconditioner="gmg", mixed_precision_cg=True, cg_rtol=1e-8)
COLUMNS = ("Bulk Energy", "Crack Energy")


def _stats(sim):
    return np.array([sim.statistics.data[c] for c in COLUMNS])


def _pair(over):
    mp = pytest.MonkeyPatch()
    mp.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
    try:
        sim_j = JSimulation(jload(PRM, **MONO, **over), verbose=False)
        sim_j.run()
    finally:
        mp.undo()
    sim = Simulation(config.load_parameters(PRM, **MONO, **over),
                     device="cpu", verbose=False)
    state = sim.run()
    return sim_j, sim, state


@pytest.fixture(scope="module")
def dense():
    return _pair({})


@pytest.fixture(scope="module")
def on_lattice():
    return _pair(LATTICE)


def test_monolithic_dense_matches_jax(dense):
    sim_j, sim, state = dense
    assert sim.sys.monolithic and sim.mesh.n_dofs == 363
    np.testing.assert_allclose(_stats(sim), _stats(sim_j), rtol=1e-10,
                               atol=0)
    assert ([e[1:3] for e in sim.solver_effort]
            == [e[1:3] for e in sim_j.solver_effort])
    phi = state.phi.numpy()
    assert phi.min() >= 0.0 and phi.max() <= 1.0 and sim.step_cuts == 0


def test_monolithic_lattice_matches_jax(on_lattice):
    sim_j, sim, _ = on_lattice
    assert sim.sys.lattice_hierarchy is not None
    assert sim.sys.lattice_hierarchy.n_levels == 2
    assert newton.check_linear_solver(sim.sys) == "lattice"
    assert sim.sys._split_jac_cache[1] == (sim.sys.with_split, True)
    ours, ref = _stats(sim), _stats(sim_j)
    for col, a, b in zip(COLUMNS, ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-7,
                                   atol=1e-12 * np.abs(b).max(), err_msg=col)
    np.testing.assert_allclose(ours[0, 0], ref[0, 0], rtol=1e-8)
    assert ([e[1:3] for e in sim.solver_effort]
            == [e[1:3] for e in sim_j.solver_effort])
    assert sim.step_cuts == 0


def _system(**over):
    """A port Simulation's System with a context, and its initial
    state, for direct calls of the linear solve."""
    sim = Simulation(config.load_parameters(SNEDDON, **{
        "n_local_pre_refine": 0, "n_refinement_cycles": 0,
        "max_no_timesteps": 0, "output_dir": "", "linear_solver": "cg",
        "preconditioner": "gmg", "mixed_precision_cg": True, **over}),
        device="cpu", verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    st = SolutionState(u=None, phi=None, u_old=None, phi_old=None,
                       phi_oold=None)
    for _ in range(sim.p.n_local_pre_refine):    # run()'s pre-refinement
        sim.interpolate_initial_values(st)
        st.u_old, st.phi_old, st.phi_oold = st.u, st.phi, st.phi
        sim.refine_mesh(st)
    sim.interpolate_initial_values(st)
    sim.timestep_number = 1
    sim._set_context()
    return sim.sys, st


@pytest.mark.parametrize("over,cache", [
    (dict(n_global_pre_refine=2), "_split_jac_cache"),
    (dict(n_global_pre_refine=1, n_local_pre_refine=1),
     "_galerkin_jac_cache")], ids=["lattice", "galerkin"])
def test_operator_caches_key_on_monolithic(over, cache):
    """C6: the same state and context, first with the active-set flag,
    then with the monolithic one, must build a second operator."""
    sys, st = _system(**over)
    on_lattice = cache == "_split_jac_cache"
    assert (sys.lattice_hierarchy is not None) == on_lattice
    assert (sys.galerkin_hierarchy is not None) != on_lattice
    u, phi = sys.apply_initial_bc(st.u, st.phi, 1.0)
    con = sys.constraints(1.0)
    active = torch.zeros(sys.mesh.n_vertices, dtype=torch.bool)
    _, pde_u, pde_p = newton._assemble(sys, u, phi, phi, phi, con, active,
                                       sys.with_split)
    args = (sys, u, phi, phi, phi, con, active, pde_u, pde_p,
            sys.with_split)
    built = []
    for mono in (False, False, True):
        sys.monolithic = mono
        newton._solve(*args)
        ctx, flags, payload = getattr(sys, cache)
        assert flags == (sys.with_split, mono)
        built.append(payload)
    assert built[1] is built[0]          # same flags: a hit
    assert built[2] is not built[1]      # only monolithic differs: a miss


def test_gamma_schedule():
    sys, _ = _system(n_global_pre_refine=1, outer_solver="simple monolithic",
                     gamma_penal=100.0)
    kw = dict(time=1.0, timestep=0.5, old_timestep=0.5, old_old_timestep=0.5,
              use_old_timestep_pf=False)
    sys.set_context(timestep_number=0, **kw)
    assert float(sys.scalars.gamma_dt) == 0.0
    sys.set_context(timestep_number=1, **kw)
    assert float(sys.scalars.gamma_dt) == pytest.approx(
        sys.params.effective_gamma_penal / 0.5)
    sys.monolithic = False
    sys.set_context(timestep_number=0, **kw)
    assert float(sys.scalars.gamma_dt) == pytest.approx(
        sys.params.effective_gamma_penal / 0.5)


def test_monolithic_step_branch(monkeypatch):
    """Reductions 1.5 (cut, retry with the old phase field), then a
    failed solve (cut, start over), then 0.5 (accepted)."""
    p = config.load_parameters(PRM, **MONO)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    z = torch.zeros(sim.mesh.n_vertices)
    state = SolutionState(u=torch.zeros(2 * sim.mesh.n_vertices), phi=z - 1,
                          u_old=None, phi_old=z + 0.5, phi_oold=z)
    state.u_old = state.u
    script = [1.5, NoConvergence(), 0.5]
    calls = []

    def solve(sys, st, time, verbose=True):
        calls.append((time, sim.timestep, sim.use_old_timestep_pf,
                      float(st.phi.min())))
        st.last_log = NewtonLog()
        out = script.pop(0)
        if isinstance(out, Exception):
            raise out
        return out

    monkeypatch.setattr(newton, "newton_iteration", solve)
    dt = sim.timestep
    sim._solve_step(state)
    # projected back before the first solve; the retry restarts from the
    # old phase field with use_old_timestep_pf; the failed solve cuts
    # again and starts over without it
    assert calls == [(dt, dt, False, 0.0),
                     (pytest.approx(dt / 10), dt / 10, True, 0.5),
                     (pytest.approx(dt / 100), dt / 100, False, 0.5)]
    assert sim.step_cuts == 2 and sim.time == pytest.approx(dt / 100)
