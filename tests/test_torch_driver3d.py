"""The Sneddon 3d slice as a whole: the PyTorch port's Simulation
(device="cpu") against the JAX Simulation on
params/parameters_sneddon_3d.prm at refine 1 (10 roots per axis, 8,000
cells, 37,044 DoFs, two load steps, cg + gmg + mixed-precision CG,
cg_rtol 1e-8).  The JAX side runs its split lattice solve (the
algorithm the port implements) by setting FUSED_SOLVE_MAX_DOFS to 0.

Bulk and crack energy agree per step to rel 1e-8, with equal DoFs and
equal Newton iterations per step, as in the 2d slice
(tests/test_torch_driver.py)."""

import os

import numpy as np
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu.config import load_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch.driver import run_prm

torch.set_num_threads(1)

PRM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params", "parameters_sneddon_3d.prm")
BENCH = dict(n_global_pre_refine=1, n_local_pre_refine=0,
             n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
             linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
             cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)


def test_sneddon3d_refine1_matches_jax(monkeypatch):
    monkeypatch.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
    sim_j = JSimulation(load_parameters(PRM, **BENCH), verbose=False)
    sim_j.run()
    sim, state = run_prm(PRM, device="cpu", **BENCH)
    dj, dt = sim_j.statistics.data, sim.statistics.data
    assert dt["DoFs"] == dj["DoFs"] == [37044, 37044]
    for col in ("Bulk Energy", "Crack Energy"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    assert ([e[1] for e in sim.solver_effort]
            == [e[1] for e in sim_j.solver_effort])
    assert sim.step_cuts == 0
    assert state.u.shape == (37044 // 4 * 3,)
