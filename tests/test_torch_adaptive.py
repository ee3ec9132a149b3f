"""The port's refinement path against the golden and the JAX package:
`params/tests/sneddon_2d_1.prm` (local pre-refinement, a hanging-node
mesh, the dense direct solve, one Sneddon refinement cycle) and the
shipped `params/parameters_sneddon_2d.prm` cut to one refinement cycle
(777 -> 1,635 DoFs), both on device="cpu".

- sneddon_2d_1: the golden table under tests/regression.py's numdiff
  rule, the pins of tests/test_regression_sneddon.py (TCV, phi L2
  error, COD at x = 0, 777 final DoFs), and the JAX run of the same
  file: statistics within rel 1e-8, equal Newton and linear iterations
  per step, cod-NN.txt and cod-NNb.txt within 1e-12;
- the shipped file, one cycle, direct solve: statistics within rel 1e-8
  of the JAX run, equal Newton and linear iterations per step (the
  Krylov variants are in tests/test_torch_adaptive_krylov.py);
- `_refine_flags` for every strategy, flag for flag equal to the JAX
  driver's on a seeded field over a hanging-node mesh;
- a run resumed from a checkpoint equals the uninterrupted run,
  refinement countdown included;
- `slow`: the full shipped file against the committed JAX table
  tests/torch_reference/parameters_sneddon_2d.statistics, and that
  table regenerated through the JAX package."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.driver import SolutionState as JSolutionState
from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation, SolutionState, run_prm

from .regression import (PARAMS_DIR, PRM_DIR, compare_statistics,
                         parse_statistics)

torch.set_num_threads(1)

GOLDEN_PRM = os.path.join(PRM_DIR, "sneddon_2d_1.prm")
SHIPPED_PRM = os.path.join(PARAMS_DIR, "parameters_sneddon_2d.prm")
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_reference", "parameters_sneddon_2d.statistics")


def _table(sim):
    return parse_statistics(sim.statistics.write_text())[1]


def assert_tables_close(ours, ref, rtol):
    """Equal shape, equal empty cells, every value within rtol."""
    assert ours.shape == ref.shape
    assert (np.isnan(ours) == np.isnan(ref)).all()
    both = ~np.isnan(ref)
    np.testing.assert_allclose(ours[both], ref[both], rtol=rtol, atol=0)


def assert_same_effort(sim, sim_j):
    """Equal Newton and linear iterations per step, no time-step cut."""
    assert ([e[1:3] for e in sim.solver_effort]
            == [e[1:3] for e in sim_j.solver_effort])
    assert sim.step_cuts == 0


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    out_j = tmp_path_factory.mktemp("jax")
    sim, _ = run_prm(GOLDEN_PRM, device="cpu", output_dir=str(out))
    sim_j, _ = jrun_prm(GOLDEN_PRM, output_dir=str(out_j))
    return sim, sim_j, out, out_j


def test_golden_statistics(golden):
    sim = golden[0]
    compare_statistics(sim.statistics.write_text(), "sneddon_2d_1.statistics")
    compare_statistics((golden[2] / "statistics").read_text(),
                       "sneddon_2d_1.statistics")


def test_golden_pins(golden):
    """tests/test_regression_sneddon.py's pins (the reference's
    tests/sneddon_2d_1.output)."""
    sim, _, out, _ = golden
    data = sim.statistics.data
    assert data["TCV"][-1] == pytest.approx(0.0418879, abs=1e-6)
    assert data["phi_L2_error"][-1] == pytest.approx(0.978645, abs=1e-5)
    sweep = np.loadtxt(out / "cod-04b.txt")
    at0 = sweep[np.isclose(sweep[:, 0], 0.0)]
    assert len(at0) == 1
    assert at0[0, 1] == pytest.approx(0.00296695, abs=1e-8)
    xs, _, exact = np.loadtxt(out / "cod-04.txt").T
    np.testing.assert_allclose(
        exact, 1.92e-3 * np.sqrt(np.maximum(0.0, 1.0 - xs ** 2)),
        atol=1e-15)
    assert sim.mesh.n_dofs == 777
    assert len(sim.mesh.hang_child) > 0


def test_golden_matches_jax(golden):
    sim, sim_j, out, out_j = golden
    assert_tables_close(_table(sim), _table(sim_j), rtol=1e-8)
    assert_same_effort(sim, sim_j)
    names = sorted(os.path.basename(f)
                   for f in glob.glob(str(out_j / "cod-*.txt")))
    assert names == ["cod-04.txt", "cod-04b.txt"]
    assert names == sorted(os.path.basename(f)
                           for f in glob.glob(str(out / "cod-*.txt")))
    for name in names:
        ours, ref = np.loadtxt(out / name), np.loadtxt(out_j / name)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_shipped_one_cycle_direct_matches_jax(tmp_path):
    """The shipped file cut to one refinement cycle (777 -> 1,635 DoFs,
    the dense direct solve throughout)."""
    sim, _ = run_prm(SHIPPED_PRM, device="cpu", n_refinement_cycles=1,
                     output_dir=str(tmp_path))
    sim_j, _ = jrun_prm(SHIPPED_PRM, n_refinement_cycles=1, output_dir="")
    assert sim.statistics.data["DoFs"] == [777] * 4 + [1635] * 4
    assert_tables_close(_table(sim), _table(sim_j), rtol=1e-8)
    assert_same_effort(sim, sim_j)


def _hanging_2d_sims():
    """A port and a JAX Simulation of sneddon_2d_1 on the same
    pre-refined (hanging-node) mesh."""
    kw = dict(output_dir="", ref_strategy="phase field")
    sim = Simulation(config.load_parameters(GOLDEN_PRM, **kw), device="cpu",
                     verbose=False)
    sim_j = JSimulation(jload_parameters(GOLDEN_PRM, **kw), verbose=False)
    for s in (sim, sim_j):
        flags = np.all(np.abs(s.mesh.cell_coords.mean(axis=1)) < 5, axis=1)
        s.mesh, _, _ = s.forest.refine_and_transfer(
            flags, s.mesh, [np.zeros(s.mesh.n_vertices)])
    assert len(sim.mesh.hang_child) > 0
    return sim, sim_j


@pytest.mark.parametrize("strategy", config.REF_STRATEGIES)
def test_refine_flags_match_jax(strategy):
    sim, sim_j = _hanging_2d_sims()
    rng = np.random.default_rng(7)
    n_v = sim.mesh.n_vertices
    u = rng.normal(scale=1e-3, size=2 * n_v)
    phi = rng.uniform(0.0, 1.0, n_v)
    for s in (sim, sim_j):
        s.p = s.p.replace(ref_strategy=strategy)
    state = SolutionState(*(torch.as_tensor(a) for a in (u, phi, u, phi,
                                                          phi)))
    state_j = JSolutionState(*(jnp.asarray(a) for a in (u, phi, u, phi,
                                                        phi)))
    flags = sim._refine_flags(state)
    flags_j = np.asarray(sim_j._refine_flags(state_j))
    assert flags.dtype == bool and flags.shape == (sim.mesh.n_cells,)
    np.testing.assert_array_equal(flags, flags_j)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """After tests/test_checkpoint.py::
    test_resume_carries_refinement_cycle_countdown: the rolling
    checkpoint of a run stopped at the step whose stationarity used the
    one refinement cycle carries the refined mesh and the exhausted
    countdown; resumed to the uninterrupted run's step count it ends on
    the same mesh with the same table."""
    full, _ = run_prm(GOLDEN_PRM, device="cpu", max_no_timesteps=5,
                      output_dir=str(tmp_path / "full"))
    assert full.refinement_cycles_left == 0 and full.mesh.n_dofs == 777
    stopped, _ = run_prm(GOLDEN_PRM, device="cpu", max_no_timesteps=3,
                         checkpoint_every=1,
                         output_dir=str(tmp_path / "ckpt"))
    assert stopped.refinement_cycles_left == 0
    assert stopped.mesh.n_dofs == 777
    resumed, state = run_prm(
        GOLDEN_PRM, device="cpu", max_no_timesteps=5,
        output_dir=str(tmp_path / "resumed"),
        resume_from=str(tmp_path / "ckpt" / "checkpoint.npz"))
    assert resumed.refinement_cycles_left == 0
    assert resumed.mesh.n_dofs == full.mesh.n_dofs
    assert state.u.dtype == torch.float64
    assert_tables_close(_table(resumed), _table(full), rtol=1e-8)


@pytest.mark.slow
def test_shipped_file_matches_committed_jax_table(tmp_path):
    """The shipped file as is (four epochs, 777 -> 12,993 DoFs; the
    last one on the assembled Jacobi CG) against the JAX package's
    table."""
    sim, _ = run_prm(SHIPPED_PRM, device="cpu", output_dir=str(tmp_path))
    with open(REFERENCE) as f:
        ref = parse_statistics(f.read())[1]
    ours = parse_statistics((tmp_path / "statistics").read_text())[1]
    assert_tables_close(ours, ref, rtol=1e-7)
    assert sim.step_cuts == 0


@pytest.mark.slow
def test_committed_jax_table_regenerates(tmp_path):
    """tests/torch_reference/parameters_sneddon_2d.statistics is what
    the JAX package writes for the shipped file."""
    jrun_prm(SHIPPED_PRM, output_dir=str(tmp_path))
    with open(REFERENCE) as f:
        assert (tmp_path / "statistics").read_text() == f.read()
