"""The port's predictor-corrector loop on the Miehe shear golden against
the JAX package, device="cpu": `miehe_shear_1` through its first two
refinements (8 rows, 891 -> 918 -> 984 DoFs).  The loop redoes steps 6
and 7 on the refined mesh, and logs one "Timestep" line per step and
one "MESH CHANGED!" per redo.  Held to the golden under the JAX prefix
test's tolerances (|d| <= 1e-6 or rel <= 1e-8) and to the JAX run of
the same prefix within rel 1e-8, with equal DoF columns and equal
Newton and linear iterations per solve.  A run checkpointed after step
5 and resumed through step 7 refines under the same level cap and h
(the loader restores the run's own n_global_pre_refine) and ends on the
uninterrupted run's mesh with its table."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch import checkpoint, config
from cracks_tpu_torch.driver import run_prm

from .test_torch_cases import (_prm, _table, assert_golden_prefix,
                               assert_matches_jax_run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shear_1():
    """The port's run of the first 8 steps, and its log."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sim, _ = run_prm(_prm("miehe_shear_1"), device="cpu",
                         max_no_timesteps=7, output_dir="")
    return sim, out.getvalue()


def test_miehe_shear_1_through_two_refinements(shear_1):
    sim, log = shear_1
    sim_j, _ = jrun_prm(_prm("miehe_shear_1"), max_no_timesteps=7,
                        output_dir="")
    assert_golden_prefix(sim, "miehe_shear_1.statistics", 8)
    assert_matches_jax_run(sim, sim_j)
    assert sim.statistics.data["DoFs"] == [891] * 6 + [918, 984]
    assert sim.redos == 2 and len(sim.solver_effort) == 10
    assert [e[0] for e in sim.solver_effort] == [0, 1, 2, 3, 4, 5, 6, 6, 7, 7]
    assert log.count("MESH CHANGED!") == 2
    assert re.findall(r"^Timestep (\d+):", log, re.M) == [str(i)
                                                         for i in range(8)]


def test_miehe_shear_1_resume_equals_uninterrupted(shear_1, tmp_path):
    full, _ = shear_1
    stopped, _ = run_prm(_prm("miehe_shear_1"), device="cpu",
                         max_no_timesteps=5, checkpoint_every=1,
                         output_dir=str(tmp_path / "ckpt"))
    assert stopped.mesh.n_dofs == 891
    p = config.load_parameters(
        _prm("miehe_shear_1"), max_no_timesteps=7,
        output_dir=str(tmp_path / "resumed"),
        resume_from=str(tmp_path / "ckpt" / "checkpoint.npz"))
    resumed, state = checkpoint.load_checkpoint(p.resume_from, p,
                                                device="cpu")
    # the level cap and h count the run's 3 global refinements
    assert resumed.p == p and resumed.p.n_global_pre_refine == 3
    resumed.run(state)
    assert resumed.redos == 2
    assert resumed.mesh.n_dofs == full.mesh.n_dofs == 984
    np.testing.assert_allclose(_table(resumed), _table(full), rtol=1e-8,
                               atol=0)
