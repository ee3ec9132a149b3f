"""The multiple-crack cases of the PyTorch port (`multiple homo`,
`multiple het` with the bitmap material of test.pgm) against the
goldens and the JAX package, device="cpu", f64:

- hetero_3d_1 (3d, bitmap material, one local pre-refinement) under
  cg + gmg, as the JAX package's test_hetero_3d_gmg_iterations runs
  it: the golden's first row under that test's tolerances (|d| <= 1e-6
  or rel <= 3e-3: the JAX package's measured discretization gap to the
  reference), the Galerkin hierarchy built, at most 60 linear
  iterations per Newton iteration, and the JAX run within rel 1e-8
  with equal DoFs and equal Newton and linear iterations;
- the two shipped 2d files, cut to a size where both packages take the
  same Newton steps (dense direct solve, LAPACK on both sides): three
  steps of the homogeneous file at global refinement 3 with one
  adaptive cycle (243 -> 867 DoFs, the first step redone once), and
  the first step of the heterogeneous file the same way.  Both equal
  the JAX runs within rel 1e-8 with equal DoF columns and Newton
  counts.  At the shipped sizes the two packages part at a line search
  that compares residuals at the rounding floor (ROADMAP C11);
- the energy's raw-bitmap quirk (the energy Lame fields use the bitmap
  E without the assembly's +1 offset, cracks.cc:3651) and the VTU
  `emodulus` cell data (1 + bitmap E), against the JAX package;
- the mesh-dependent h: the coarse-diameter formula for `multiple
  homo`, the minimal cell diameter for `multiple het`, as in JAX."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import PGM_PATH, Simulation, run_prm

from .regression import PRM_DIR
from .test_regression_adaptive import _prefix_match

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HETERO = os.path.join(PRM_DIR, "hetero_3d_1.prm")
MULTIPLE = {w: os.path.join(ROOT, "params",
                            f"parameters_{w}_multiple_cracks.prm")
            for w in ("homo", "hetero")}


def _assert_runs_equal(sim, sim_j, rtol=1e-8):
    dt, dj = sim.statistics.data, sim_j.statistics.data
    assert dt["DoFs"] == dj["DoFs"]
    for col in ("Bulk Energy", "Crack Energy"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=rtol, atol=0,
                                   err_msg=col)
    assert ([e[1] for e in sim.solver_effort]
            == [e[1] for e in sim_j.solver_effort])


def test_hetero_3d_gmg_matches_golden_and_jax():
    over = dict(output_dir="", max_no_timesteps=0, linear_solver="cg",
                preconditioner="gmg")
    sim_j, _ = jrun_prm(HETERO, **over)
    sim, state = run_prm(HETERO, device="cpu", **over)
    _prefix_match(sim, "hetero_3d_1.mpirun-4.statistics", 1, atol=1e-6,
                  rtol=3e-3)
    assert sim.mesh.n_dofs == 5288 and len(sim.mesh.hang_child) > 0
    assert sim.sys.galerkin_hierarchy is not None
    for step, newton_its, lin_its, *_ in sim.solver_effort:
        assert newton_its > 0
        assert lin_its / newton_its <= 60, (step, newton_its, lin_its)
    _assert_runs_equal(sim, sim_j)
    assert ([e[2] for e in sim.solver_effort]
            == [e[2] for e in sim_j.solver_effort])
    assert state.u.dtype == torch.float64


@pytest.mark.parametrize("which,steps,dofs", [
    ("homo", 2, [867, 867, 867]), ("hetero", 0, [867])])
def test_shipped_2d_files_match_jax(which, steps, dofs, tmp_path):
    over = dict(n_global_pre_refine=3, n_refinement_cycles=1,
                max_no_timesteps=steps)
    p_j = jload_parameters(MULTIPLE[which], output_dir="", **over)
    sim_j = JSimulation(p_j, verbose=False)
    sim_j.run()
    sim, _ = run_prm(MULTIPLE[which], device="cpu",
                     output_dir=str(tmp_path), write_vtu=True, **over)
    assert sim.statistics.data["DoFs"] == dofs
    assert sim.redos >= 1 and sim.step_cuts == 0
    assert ([e[2] for e in sim.solver_effort]
            == [e[1] for e in sim.solver_effort])     # dense direct
    _assert_runs_equal(sim, sim_j)
    vtu = (tmp_path / "solution_b_00001.vtu").read_text()
    assert ('Name="emodulus"' in vtu) == (which == "hetero")


def _simulation_pair(which, **over):
    p = config.load_parameters(MULTIPLE[which], output_dir="", **over)
    p_j = jload_parameters(MULTIPLE[which], output_dir="", **over)
    sim, sim_j = Simulation(p, device="cpu", verbose=False), \
        JSimulation(p_j, verbose=False)
    for s in (sim, sim_j):
        s.setup_system()
        s.determine_mesh_dependent_parameters()
    return sim, sim_j


def test_energy_uses_the_raw_bitmap():
    sim, sim_j = _simulation_pair("hetero", n_global_pre_refine=3)
    assert os.path.samefile(PGM_PATH, os.path.join(ROOT, "test.pgm"))
    lam_e, mu_e = (t.numpy() for t in sim.sys.lam_mu_dev)
    np.testing.assert_array_equal(lam_e, np.asarray(sim_j._energy_lam()))
    np.testing.assert_array_equal(mu_e, np.asarray(sim_j._energy_mu()))
    # the assembly's fields carry the +1 offset, the energy's do not
    np.testing.assert_array_equal(sim.sys.lam_cells, sim_j.sys.lam_cells)
    nu = sim.p.poisson_ratio_nu
    E_raw = sim.bitmap.value(sim.mesh.cell_coords.mean(axis=1))
    np.testing.assert_allclose(mu_e, E_raw / (2 * (1 + nu)), rtol=1e-15)
    np.testing.assert_allclose(sim.sys.mu_cells, (E_raw + 1) / (2 * (1 + nu)),
                               rtol=1e-15)
    assert np.std(sim.sys.lam_cells) > 0


@pytest.mark.parametrize("which", ["homo", "hetero"])
def test_mesh_dependent_h(which):
    over = dict(n_global_pre_refine=2, n_refinement_cycles=3,
                n_local_pre_refine=1)
    sim, sim_j = _simulation_pair(which, **over)
    assert sim.min_cell_diameter == sim_j.min_cell_diameter
    assert (sim.constant_k, sim.alpha_eps) == (sim_j.constant_k,
                                               sim_j.alpha_eps)
    if which == "homo":
        # the coarse cells' largest diameter halved per global, cycle
        # and local refinement
        assert sim.min_cell_diameter == sim.coarse_max_diameter * 2.0 ** -6
    else:
        assert sim.min_cell_diameter == sim.mesh.min_cell_diameter
