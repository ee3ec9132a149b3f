"""The port's Miehe shear case (the spectral split in the matrix and the
rhs) on a fixed mesh against its golden and the JAX package,
device="cpu": `miehe_shear_2`, its first 5 rows (891 DoFs), held to the
golden under the JAX prefix test's tolerances (|d| <= 1e-6 or rel <=
1e-8) and to the JAX run of the same prefix within rel 1e-8, with equal
DoF columns and equal Newton and linear iterations per solve (the
adaptive shear golden is in tests/test_torch_cases_shear_adaptive.py)."""

import torch

from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu_torch.driver import run_prm

from .test_torch_cases import (_prm, assert_golden_prefix,
                               assert_matches_jax_run)

torch.set_num_threads(1)


def test_miehe_shear_2_prefix():
    sim, _ = run_prm(_prm("miehe_shear_2"), device="cpu", max_no_timesteps=4,
                     output_dir="")
    sim_j, _ = jrun_prm(_prm("miehe_shear_2"), max_no_timesteps=4,
                        output_dir="")
    assert_golden_prefix(sim, "miehe_shear_2.statistics", 5)
    assert_matches_jax_run(sim, sim_j)
    assert sim.redos == 0 and sim.statistics.columns[-1] == "Load x"
