"""Write the JAX package's references for the port's shipped-file checks.

    JAX_PLATFORMS=cpu python scripts/torch_reference.py [name ...]

Runs shipped files through the JAX package (``cracks_tpu.driver.run_prm``)
on the CPU, in float64, and writes into ``tests/torch_reference/``, for
each run `name`:

- ``<name>.statistics``: the statistics table the run writes;
- ``<name>.effort.json``: per Newton solve (a step the predictor-corrector
  loop redoes on a refined mesh has one entry per solve), the step
  number, the DoFs the step ended on and the Newton and linear
  iterations.

The runs (all of them without arguments, else the named ones):

- ``parameters_sneddon_2d``: ``params/parameters_sneddon_2d.prm`` as
  shipped (16 load steps over four mesh epochs, 777 -> 12,993 DoFs;
  about two minutes);
- ``parameters_miehe_shear_adaptive``:
  ``params/parameters_miehe_shear_adaptive.prm`` as shipped, its first
  100 steps (``max_no_timesteps=99``; 3,315 DoFs before the crack grows;
  about ten minutes);
- ``parameters_miehe_tension_adaptive``:
  ``params/parameters_miehe_tension_adaptive.prm`` as shipped, its first
  86 steps (``max_no_timesteps=85``; of 89: the whole file takes over
  40 minutes on an 8-core CPU), two adaptive cycles under the level
  cap, K reg = 0, the load's peak and fall inside them;
- ``sneddon_2d_matrix_free_r4``: ``params/parameters_sneddon_2d.prm``
  at global refinement 4 (77,763 DoFs), two load steps, on the
  matrix-free operator (``assembled_matvec=False``) under the
  mixed-precision Jacobi CG (`ROUND1`).

``chip_smoke.py`` holds the port's runs of the same files on the card
against these (the card's machine has no JAX).
"""

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_reference")
# the round-1 configuration: the matrix-free jvp operator
# (assembled_matvec = False) at global refinement 4, two load steps
ROUND1 = dict(n_global_pre_refine=4, n_local_pre_refine=0,
              n_refinement_cycles=0, max_no_timesteps=1,
              linear_solver="cg", preconditioner="jacobi", cg_rtol=1e-8,
              cg_maxiter=3000, dtype="float64", mixed_precision_cg=True,
              assembled_matvec=False)
# name -> (the .prm under params/, overrides)
RUNS = {
    "parameters_sneddon_2d": ("parameters_sneddon_2d", dict()),
    "parameters_miehe_shear_adaptive": ("parameters_miehe_shear_adaptive",
                                        dict(max_no_timesteps=99)),
    "parameters_miehe_tension_adaptive": (
        "parameters_miehe_tension_adaptive", dict(max_no_timesteps=85)),
    "sneddon_2d_matrix_free_r4": ("parameters_sneddon_2d", ROUND1),
}


def write_reference(name, prm, overrides):
    from cracks_tpu.driver import run_prm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sim, _ = run_prm(os.path.join(ROOT, "params", f"{prm}.prm"),
                         output_dir=tmp, **overrides)
        shutil.copy(os.path.join(tmp, "statistics"),
                    os.path.join(OUT, f"{name}.statistics"))
    dofs = {step: n for step, n, _ in sim.step_times}
    effort = [dict(step=step, dofs=dofs[step], newton=newton, linear=lin)
              for step, newton, lin in sim.solver_effort]
    with open(os.path.join(OUT, f"{name}.effort.json"), "w") as f:
        json.dump(effort, f, indent=1)
        f.write("\n")
    print(f"{name}: {time.perf_counter() - t0:.1f} s, "
          f"{len(sim.step_times)} steps, final DoFs {sim.mesh.n_dofs}")


def main(names):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    os.makedirs(OUT, exist_ok=True)
    for name in names or RUNS:
        write_reference(name, *RUNS[name])


if __name__ == "__main__":
    main(sys.argv[1:])
