"""Write the JAX package's reference for the port's shipped-file check.

    JAX_PLATFORMS=cpu python scripts/torch_reference.py

Runs ``params/parameters_sneddon_2d.prm`` as shipped through the JAX
package (``cracks_tpu.driver.run_prm``) on the CPU, in float64, and
writes into ``tests/torch_reference/``:

- ``parameters_sneddon_2d.statistics``: the statistics table the run
  writes (16 load steps over four mesh epochs, 777 -> 12,993 DoFs);
- ``parameters_sneddon_2d.effort.json``: per load step, the step
  number, DoFs and the Newton and linear iterations.

``chip_smoke.py`` holds the port's run of the same file on the card
against both (the card's machine has no JAX).  Takes about two minutes.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_reference")
PRM = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from cracks_tpu.driver import run_prm

    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        sim, _ = run_prm(PRM, output_dir=tmp)
        shutil.copy(os.path.join(tmp, "statistics"),
                    os.path.join(OUT, "parameters_sneddon_2d.statistics"))
    dofs = {step: n for step, n, _ in sim.step_times}
    effort = [dict(step=step, dofs=dofs[step], newton=newton, linear=lin)
              for step, newton, lin in sim.solver_effort]
    with open(os.path.join(OUT, "parameters_sneddon_2d.effort.json"),
              "w") as f:
        json.dump(effort, f, indent=1)
        f.write("\n")
    print(json.dumps(effort))


if __name__ == "__main__":
    main()
