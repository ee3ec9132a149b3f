"""The seam lattice end to end: params/tests/miehe_shear_2.prm (the slit
mesh at global refinement 3, 891 DoFs) under bench.py's solver settings
(cg + gmg + mixed-precision CG, cg_rtol 1e-8), cut to 3 load steps
(step >= 1 turns the split on), on the CPU:

- the port's Simulation builds the seam lattice (2 levels, seam at row
  8, glued columns [0, 9)) and equals the JAX package's split solve
  (``FUSED_SOLVE_MAX_DOFS = 0``) per step: bulk energy, crack energy and
  "Load x" within rel 1e-8 or abs 1e-12 (the tolerance of the JAX
  package's own seam test, tests/test_seam.py; step 0's crack energy,
  9.9e-6, differs by 3.0e-13), equal DoFs and Newton iterations, and
  linear iterations within 2 per Newton solve (ROADMAP C9);
- the port's forced Galerkin hierarchy on the same mesh equals the seam
  lattice on step 0 at the same tolerance.  From step 1 on the two
  solves part at a line search at the rounding floor (ROADMAP C11): the
  JAX package's split seam lattice and its Galerkin GMG part there the
  same way (crack energy 4.0102e-5 against 4.0767e-5 at step 1);
- ``dof_sharding = lattice`` (the lattice-layout Newton, the
  conjugated residual) at D = 1 and D = 4 row slabs equals the
  replicated run to rel 1e-9 with equal Newton and linear iterations."""

import os

import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu.config import load_parameters as jload
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch import config, problems
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.solvers import galerkin, lattice

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(ROOT, "params", "tests", "miehe_shear_2.prm")
# tests/test_seam.py's _miehe_sim: bench.py's overrides, 3 steps
MIEHE = dict(max_no_timesteps=2, output_dir="", linear_solver="cg",
             direct_solver=False, preconditioner="gmg",
             mixed_precision_cg=True, cg_rtol=1e-8)
COLUMNS = ("Bulk Energy", "Crack Energy", "Load x")


def _stats(sim):
    return np.array([sim.statistics.data[c] for c in COLUMNS])


def _run(**over):
    sim = Simulation(config.load_parameters(PRM, **{**MIEHE, **over}),
                     device="cpu", verbose=False)
    sim.run()
    return sim


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
    try:
        sim_j = JSimulation(jload(PRM, **MIEHE), verbose=False)
        sim_j.run()
    finally:
        mp.undo()
    return dict(jax=sim_j, port=_run())


def _close(a, b, rel, what):
    np.testing.assert_allclose(a, b, rtol=rel, atol=1e-12, err_msg=what)


def test_seam_lattice_matches_jax_split(runs):
    sim_j, sim = runs["jax"], runs["port"]
    hier = sim.sys.lattice_hierarchy
    assert hier is not None and sim.sys.galerkin_hierarchy is None
    assert hier.seam == lattice.Seam(s=8, slit_lo=9) and hier.n_levels == 2
    assert sim_j.sys.lattice_hierarchy.seam == tuple(hier.seam)
    dj, dt = sim_j.statistics.data, sim.statistics.data
    assert dt["DoFs"] == dj["DoFs"] == [891] * 3
    for i, col in enumerate(COLUMNS):
        _close(_stats(sim)[i], _stats(sim_j)[i], 1e-8, col)
    newton = [e[1] for e in sim.solver_effort]
    assert newton == [e[1] for e in sim_j.solver_effort]
    for (_, n, lin, _), (_, _, lin_j) in zip(sim.solver_effort,
                                             sim_j.solver_effort):
        assert abs(lin - lin_j) <= 2 * n
    assert sim.step_cuts == 0


def test_seam_lattice_matches_galerkin_on_step_0(runs):
    """The same Newton systems through the Galerkin GMG (the hierarchy
    the port takes on the slit mesh without the lattice)."""
    orig = Simulation.setup_system

    def galerkin_only(self):
        orig(self)
        self.sys.lattice_hierarchy = None
        self.sys._lattice_lay = None

        def dirichlet_fn(m):
            mu_, _, mp_, _ = problems.dirichlet_conditions(
                self.p, m, 0.0, initial_step=False)
            return mu_, mp_
        self.sys.galerkin_hierarchy = galerkin.build_galerkin_hierarchy(
            self.forest, self.mesh, dirichlet_fn, device=self.device)

    mp = pytest.MonkeyPatch()
    mp.setattr(Simulation, "setup_system", galerkin_only)
    try:
        sim_g = _run(max_no_timesteps=0)
    finally:
        mp.undo()
    assert sim_g.sys.galerkin_hierarchy is not None
    assert sim_g.sys.lattice_hierarchy is None
    sim = runs["port"]
    for i, col in enumerate(COLUMNS):
        _close(_stats(sim_g)[i, 0], _stats(sim)[i, 0], 1e-8, col)
    assert sim_g.solver_effort[0][1] == sim.solver_effort[0][1]


@pytest.mark.parametrize("n_devices", [1, 4], ids=["D1", "D4"])
def test_lattice_layout_newton_matches_replicated(runs, n_devices):
    sim = runs["port"]
    sim_s = _run(n_devices=n_devices, dof_sharding="lattice")
    assert sim_s.sys.use_lattice_state
    assert sim_s.sys.lattice_hierarchy.seam == sim.sys.lattice_hierarchy.seam
    if n_devices > 1:
        assert sim_s.sys.shard_mesh.n_shards == n_devices
    np.testing.assert_allclose(_stats(sim_s), _stats(sim), rtol=1e-9,
                               atol=0)
    assert ([e[1:3] for e in sim_s.solver_effort]
            == [e[1:3] for e in sim.solver_effort])
    assert sim_s.step_cuts == 0
