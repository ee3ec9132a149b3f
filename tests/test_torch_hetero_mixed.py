"""hetero_3d_1 under tests/test_halo_newton.py's settings (BASE: cg, gmg,
cg_rtol 1e-10, mixed precision), two load steps, replicated vectors:
the port's mixed-precision Galerkin solve against the JAX package's
(ROADMAP C15, closed).

- At 5,288 DoFs JAX runs its fused solve, whose block target is
  max(rtol |b|, 100 eps |b|); its split solve (``FUSED_SOLVE_MAX_DOFS
  = 0``) adds the floor 1e-3 x the Newton lower bound (1e-9 here).  The
  port has only the split solve and takes the fused solve's target up
  to JAX's threshold (`galerkin.block_target`).
- Its default run is JAX's default (fused) run within JAX's np1/np8
  tolerance (abs 1e-6 or rel 1e-7, tests/test_halo_newton.py:44-49),
  with equal Newton iterations per step: step 1 takes 5 at bulk energy
  0.6248006.  With the port's threshold monkeypatched to 0 it is JAX's
  split run to rel 1e-8: the floor stops step 1 after 4 Newton
  iterations at 0.6248075, 1.1e-5 off, outside that tolerance (at
  iteration 3 the full step misses the previous residual by 1 %, the
  line search fails and the next head sees an unchanged active set).
"""

import os

import numpy as np
import pytest
import torch

from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.solvers import lattice as jlat
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.solvers import galerkin

from tests.regression import PRM_DIR

torch.set_num_threads(1)
HETERO = os.path.join(PRM_DIR, "hetero_3d_1.prm")
BASE = dict(output_dir="", direct_solver=False, linear_solver="cg",
            preconditioner="gmg", cg_rtol=1e-10, mixed_precision_cg=True,
            max_no_timesteps=1)
COLS = ("Bulk Energy", "Crack Energy")


def _stats(sim):
    return np.array([sim.statistics.data[c] for c in COLS], dtype=float)


def _newton(sim):
    return [e[1] for e in sim.solver_effort]


def _jax(fused: bool):
    with pytest.MonkeyPatch.context() as mp:
        if not fused:
            mp.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
        sim = JSimulation(jload_parameters(HETERO, **BASE), verbose=False)
        sim.run()
    return sim


def _port(**over):
    sim = Simulation(config.load_parameters(HETERO, **BASE, **over),
                     device="cpu", verbose=False)
    sim.run()
    return sim


def _np1_np8_close(a, b):
    d = np.abs(a - b)
    return bool(((d <= 1e-6) | (d <= 1e-7 * np.abs(a))).all())


@pytest.fixture(scope="module")
def port_mixed():
    sim = _port()
    assert len(sim.mesh.hang_child) > 0 and sim.mesh.n_dofs == 5288
    return sim


@pytest.fixture(scope="module")
def port_split():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(galerkin, "FUSED_SOLVE_MAX_DOFS", 0)
        return _port()


def test_block_target_sides_of_the_threshold():
    """The fused target up to FUSED_SOLVE_MAX_DOFS, the split solve's
    floor above it."""
    n = galerkin.FUSED_SOLVE_MAX_DOFS
    assert n == 150000
    eps = float(np.finfo(np.float64).eps)
    for bnorm in (1e-4, 1e-12):
        fused = max(1e-10 * bnorm, 100 * eps * bnorm)
        assert galerkin.block_target(bnorm, 1e-10, 1e-6, n) == fused
        assert galerkin.block_target(bnorm, 1e-10, 1e-6, n + 1) == max(
            fused, 1e-9)
    # the floor binds only on small right-hand sides
    assert galerkin.block_target(1e-12, 1e-10, 1e-6, n + 1) == 1e-9
    assert galerkin.block_target(1e-12, 1e-10, 1e-6, n) < 1e-20


def test_mixed_run_is_jax_split_solve(port_split):
    """The port with its threshold at 0 is JAX's split run."""
    jsim = _jax(fused=False)
    np.testing.assert_allclose(_stats(port_split), _stats(jsim), rtol=1e-8,
                               atol=0)
    assert _newton(port_split) == _newton(jsim)
    assert _newton(port_split)[1] == 4


def test_split_floor_is_the_gap_to_the_fused_solve(port_mixed, port_split):
    """The port's default mixed run is JAX's default (fused) run; the
    split solve's floor is what parts the two."""
    jsim = _jax(fused=True)
    fused = _stats(jsim)
    assert _newton(jsim)[1] == 5
    assert _np1_np8_close(fused, _stats(port_mixed))
    assert _newton(port_mixed) == _newton(jsim)
    assert not _np1_np8_close(fused, _stats(port_split))
