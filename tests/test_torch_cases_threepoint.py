"""The port's three-point-bending case against its golden and the JAX
package, device="cpu": `threepoint_1`, its first 4 rows (975 DoFs, the
gmsh mesh with its recoloured boundaries, the split).  The golden is an
mpirun=2 run, held at rel 1e-3 as tests/test_regression_threepoint.py
holds it; the JAX run of the same prefix within rel 1e-8, with equal
DoF columns and equal Newton and linear iterations per solve."""

import torch

from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch.driver import run_prm

from .test_torch_cases import (_prm, assert_golden_prefix,
                               assert_matches_jax_run)

torch.set_num_threads(1)


def test_threepoint_prefix():
    sim, _ = run_prm(_prm("threepoint_1"), device="cpu", max_no_timesteps=3,
                     output_dir="")
    sim_j, _ = jrun_prm(_prm("threepoint_1"), max_no_timesteps=3,
                        output_dir="")
    assert_golden_prefix(sim, "threepoint_1.mpirun=2.statistics", 4,
                         rtol=1e-3)
    assert_matches_jax_run(sim, sim_j)
    assert sim.mesh.n_dofs == 975
    assert sim.statistics.columns[-1] == "Load P11"
