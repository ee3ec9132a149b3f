"""The shipped `params/parameters_sneddon_2d.prm` cut to one refinement
cycle (777 -> 1,635 DoFs, hanging-node meshes) through the port's
stored-element-matrix Jacobi CG (`linear_solver=cg`, the solve the
shipped file takes above 8,000 DoFs) on device="cpu", against the JAX
package's run of the same configuration.

- f64 (`mixed_precision_cg=False`): statistics within rel 1e-8, equal
  Newton iterations per step, and linear iterations within 5 % per
  step.  They are not equal: the second Newton solve of a step starts
  from a right-hand side near the f64 rounding floor of the residual
  assembly, where the two packages' sums differ in their last bits,
  and a CG to cg_rtol = 1e-12 then takes a few iterations more or less
  (on one and the same system the counts are equal:
  tests/test_torch_linear.py).
- mixed precision: equal Newton iterations per step, bulk and crack
  energy within 1e-9 * max(1, |E|) and the final fields within 1e-5
  (the tolerances of tests/test_assembled.py); the f32 passes round
  differently in the two packages, so their linear counts are not
  compared."""

import os

import numpy as np
import pytest
import torch

from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch.driver import run_prm

from .regression import PARAMS_DIR
from .test_torch_adaptive import _table, assert_tables_close

torch.set_num_threads(1)

SHIPPED_PRM = os.path.join(PARAMS_DIR, "parameters_sneddon_2d.prm")
ONE_CYCLE = dict(n_refinement_cycles=1, output_dir="", linear_solver="cg")


@pytest.fixture(scope="module", params=[False, True], ids=["f64", "mixed"])
def runs(request):
    kw = dict(ONE_CYCLE, mixed_precision_cg=request.param)
    sim, state = run_prm(SHIPPED_PRM, device="cpu", **kw)
    sim_j, state_j = jrun_prm(SHIPPED_PRM, **kw)
    return request.param, (sim, state), (sim_j, state_j)


def test_one_cycle_matches_jax(runs):
    mixed, (sim, state), (sim_j, state_j) = runs
    assert sim.statistics.data["DoFs"] == [777] * 4 + [1635] * 4
    assert sim.step_cuts == 0
    assert sim.sys.lattice_hierarchy is None
    newton = [[e[1] for e in s.solver_effort] for s in (sim, sim_j)]
    assert newton[0] == newton[1]
    if not mixed:
        assert_tables_close(_table(sim), _table(sim_j), rtol=1e-8)
        for e, e_j in zip(sim.solver_effort, sim_j.solver_effort):
            assert abs(e[2] - e_j[2]) <= 0.05 * e_j[2], (e, e_j)
        return
    for col in ("Bulk Energy", "Crack Energy"):
        ours = np.array(sim.statistics.data[col])
        ref = np.array(sim_j.statistics.data[col])
        assert (np.abs(ours - ref) <= 1e-9 * np.maximum(1.0, np.abs(ref))
                ).all(), col
    assert np.abs(state.u.numpy() - np.asarray(state_j.u)).max() < 1e-5
    assert np.abs(state.phi.numpy() - np.asarray(state_j.phi)).max() < 1e-5
