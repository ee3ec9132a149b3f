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
  mixed-precision Jacobi CG (`ROUND1`);
- ``sneddon_2d_1_halo8``: ``params/tests/sneddon_2d_1.prm`` on the mesh
  of ``__graft_entry__.dryrun_multichip``'s halo step (one local
  pre-refinement at phase-field value 0.5, no refinement cycle: 453
  DoFs, 12 hanging vertices), two load steps under the Jacobi CG, at
  ``n_devices=8, dof_sharding=lattice``: the owned+ghost halo pool on 8
  virtual CPU devices (`HALO8`; about twelve minutes on an 8-core CPU,
  nearly all of it XLA compiling the pool's ``shard_map`` programs);
- ``sneddon_2d_1_halo4``: the same at ``n_devices=4`` (`HALO4`);
- ``hetero_3d_1_halo4``: ``params/tests/hetero_3d_1.prm`` as shipped
  (5,288 DoFs), two load steps under ``tests/test_halo_newton.py``'s
  settings (cg + gmg, cg_rtol 1e-10, mixed precision) at
  ``n_devices=4, dof_sharding=lattice`` (`HETERO_HALO4`: the pool takes
  its Jacobi CG all the same);
- ``sneddon_2d_lattice_np8``: the Sneddon 2d lattice of
  ``tests/test_torch_driver_sharded.py`` (its `SNEDDON` settings, refine
  2, 5,043 DoFs, four load steps) at ``n_devices=8,
  dof_sharding=lattice``: the lattice-layout Newton on 8 virtual CPU
  devices (`LATTICE_RUNS`; writes ``<name>.json``: the statistics
  columns and each step's Newton and linear iterations, for
  ``tests/test_torch_dist_lattice.py``, whose ranks do not import JAX);
- ``sneddon_3d_lattice_np4``: the same settings in 3d at refine 1
  (37,044 DoFs), load step 0, at ``n_devices=4``;
- ``miehe_shear_2_lattice_np4``: ``params/tests/miehe_shear_2.prm`` at
  global refinement 4 (the (34, 33) seam lattice, slit row 16, 3,315
  DoFs), three load steps under ``tests/test_torch_cases_seam.py``'s
  `MIEHE` settings, at ``n_devices=4, dof_sharding=lattice``: the seam
  lattice in the lattice-layout Newton on 4 virtual CPU devices, with
  ``FUSED_SOLVE_MAX_DOFS = 0`` (the split solve, the one the port
  implements), for ``tests/test_torch_dist_seam.py``;
- ``replicated_np{2,4}_<case>``: the replicated cell-axis mode
  (``n_devices = D``, replicated DoF vectors) on D virtual CPU devices,
  for ``tests/test_torch_dist_replicated.py`` (`REPLICATED_RUNS`;
  writes ``<name>.json`` as the lattice runs do): ``sneddon_2d_1`` as
  shipped (the dense direct solve) at D = 2; the Sneddon 2d bench
  settings of ``tests/test_torch_driver.py`` at refine 3 (19,683 DoFs,
  two load steps, the split lattice solve) at D = 4;
  ``miehe_shear_1`` under the simple monolithic solver on the
  matrix-free Jacobi CG, load step 0, at D = 2; ``threepoint_1``'s
  first four load steps at D = 2 (about five minutes in all);
- ``halo_cg_2d``: one call of the halo pool's block CG
  (``cracks_tpu.solvers.halo_newton.build_halo_cg``, the split on) at
  D = 8 on the hanging-node mesh of
  ``tests/test_halo_newton.py::test_halo_partition_hanging_condensation``,
  on inputs drawn from ``numpy.random.default_rng(13)``; writes
  ``halo_cg_2d.npz``: the global inputs and JAX's updates and
  iteration count (about a minute, the compilation of its while loops).

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
# the halo pool: the dryrun's hanging-node mesh on 8 shards
HALO8 = dict(n_local_pre_refine=1, value_phase_field_for_refinement=0.5,
             n_refinement_cycles=0, max_no_timesteps=1, linear_solver="cg",
             preconditioner="jacobi", n_devices=8, dof_sharding="lattice")
HALO4 = dict(HALO8, n_devices=4)
# tests/test_halo_newton.py's BASE (:28-29), two load steps, on 4 shards
HETERO_HALO4 = dict(direct_solver=False, linear_solver="cg",
                    preconditioner="gmg", cg_rtol=1e-10,
                    mixed_precision_cg=True, max_no_timesteps=1, n_devices=4,
                    dof_sharding="lattice")
# name -> (the .prm under params/, overrides)
RUNS = {
    "parameters_sneddon_2d": ("parameters_sneddon_2d", dict()),
    "parameters_miehe_shear_adaptive": ("parameters_miehe_shear_adaptive",
                                        dict(max_no_timesteps=99)),
    "parameters_miehe_tension_adaptive": (
        "parameters_miehe_tension_adaptive", dict(max_no_timesteps=85)),
    "sneddon_2d_matrix_free_r4": ("parameters_sneddon_2d", ROUND1),
    "sneddon_2d_1_halo8": (os.path.join("tests", "sneddon_2d_1"), HALO8),
    "sneddon_2d_1_halo4": (os.path.join("tests", "sneddon_2d_1"), HALO4),
    "hetero_3d_1_halo4": (os.path.join("tests", "hetero_3d_1"),
                          HETERO_HALO4),
}


def write_reference(name, prm, overrides):
    from cracks_tpu.driver import run_prm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sim, _ = run_prm(os.path.join(ROOT, "params", f"{prm}.prm"),
                         output_dir=tmp, **overrides)
        if overrides.get("dof_sharding") == "lattice":
            assert sim.sys.use_halo_state or sim.sys.use_lattice_state
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


# tests/test_torch_driver_sharded.py's SNEDDON (a Parameters() without
# a .prm), two runs of the lattice-layout Newton
SNEDDON = dict(
    test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
    poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
    eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
    max_no_newton_steps=50, max_no_line_search_steps=10,
    n_global_pre_refine=2, max_no_timesteps=3, output_dir="",
    linear_solver="cg", preconditioner="gmg", cg_rtol=1e-10,
    mixed_precision_cg=True)
# tests/test_torch_cases_seam.py's MIEHE: bench.py's solver settings,
# three load steps
MIEHE = dict(max_no_timesteps=2, output_dir="", linear_solver="cg",
             direct_solver=False, preconditioner="gmg",
             mixed_precision_cg=True, cg_rtol=1e-8)
# name -> (the .prm under params/ or None: Parameters() defaults,
# overrides)
LATTICE_RUNS = {
    "sneddon_2d_lattice_np8": (None, dict(SNEDDON, n_devices=8,
                                          dof_sharding="lattice")),
    "sneddon_3d_lattice_np4": ("parameters_sneddon_3d", dict(
        SNEDDON, dimension=3, n_global_pre_refine=1, max_no_timesteps=0,
        n_devices=4, dof_sharding="lattice")),
    "miehe_shear_2_lattice_np4": (os.path.join("tests", "miehe_shear_2"),
                                  dict(MIEHE, n_global_pre_refine=4,
                                       n_devices=4, dof_sharding="lattice")),
}


# tests/test_torch_driver.py's BENCH: bench.py's Sneddon settings at
# refine 3, two load steps
BENCH3 = dict(n_global_pre_refine=3, n_local_pre_refine=0,
              n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
              linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
              cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)
# the replicated cell-axis mode (tests/test_torch_dist_replicated.py's
# DRIVER_RUNS)
REPLICATED_RUNS = {
    "replicated_np2_sneddon_2d_1": (os.path.join("tests", "sneddon_2d_1"),
                                    dict(output_dir="", n_devices=2)),
    "replicated_np4_sneddon_2d_r3": ("parameters_sneddon_2d",
                                     dict(BENCH3, n_devices=4)),
    "replicated_np2_miehe_shear_1_monolithic": (
        os.path.join("tests", "miehe_shear_1"),
        dict(output_dir="", max_no_timesteps=0,
             outer_solver="simple monolithic", linear_solver="cg",
             assembled_matvec=False, n_devices=2)),
    "replicated_np2_threepoint_1": (os.path.join("tests", "threepoint_1"),
                                    dict(output_dir="", max_no_timesteps=3,
                                         n_devices=2)),
}


def write_lattice_reference(name, runs=LATTICE_RUNS):
    from cracks_tpu.config import Parameters, load_parameters
    from cracks_tpu.driver import Simulation
    from cracks_tpu.solvers import lattice

    t0 = time.perf_counter()
    prm, overrides = runs[name]
    p = (Parameters(**overrides) if prm is None else load_parameters(
        os.path.join(ROOT, "params", f"{prm}.prm"), **overrides))
    sim = Simulation(p, verbose=False)
    # the split solve, the one the port implements (the lattice-layout
    # Newton takes it at any size; the threshold pins it all the same)
    fused = lattice.FUSED_SOLVE_MAX_DOFS
    lattice.FUSED_SOLVE_MAX_DOFS = 0
    try:
        sim.run()
    finally:
        lattice.FUSED_SOLVE_MAX_DOFS = fused
    assert sim.sys.use_lattice_state == (runs is LATTICE_RUNS)
    with open(os.path.join(OUT, f"{name}.json"), "w") as f:
        json.dump(dict(statistics=sim.statistics.data,
                       effort=[dict(step=step, newton=newton, linear=lin)
                               for step, newton, lin in sim.solver_effort]),
                  f, indent=1)
        f.write("\n")
    print(f"{name}: {time.perf_counter() - t0:.1f} s, "
          f"{len(sim.solver_effort)} steps, DoFs {sim.mesh.n_dofs}")


def hanging_mesh_2d(Forest, rect_mesh):
    """The 2d hanging-node mesh of the JAX package's pooled-condensation
    test: 4 x 4 cells, once refined, a corner patch refined again under
    the 2:1 balance (91 cells, 114 vertices, 6 hanging)."""
    import numpy as np
    forest = Forest(rect_mesh([0, 0], [1, 1], [4, 4]))
    forest.refine_global(1)
    flags = np.zeros(forest.n_cells, bool)
    centers = forest.extract().cell_coords.mean(axis=1)
    flags[(centers[:, 0] < 0.4) & (centers[:, 1] < 0.4)] = True
    forest.execute_refinement(forest.balance_flags(flags))
    return forest.extract()


def write_halo_cg():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cracks_tpu.mesh import Forest
    from cracks_tpu.meshio import rect_mesh
    from cracks_tpu.ops import physics
    from cracks_tpu.parallel import halo
    from cracks_tpu.parallel.sharding import make_device_mesh
    from cracks_tpu.solvers.halo_newton import build_halo_cg

    t0 = time.perf_counter()
    mesh = hanging_mesh_2d(Forest, rect_mesh)
    n_v = mesh.n_vertices
    rng = np.random.default_rng(13)
    x = mesh.vert_coords[:, 0]
    # clamped left and right edges; an active set on a tenth of the
    # phase field
    dir_u = np.repeat((x < 1e-12) | (x > 1 - 1e-12), 2)
    inp = dict(
        u=rng.standard_normal(2 * n_v) * 1e-3,
        phi=rng.uniform(0.3, 1.0, n_v), phi_old=rng.uniform(0.3, 1.0, n_v),
        dirichlet_u=dir_u, dirichlet_p=np.zeros(n_v, bool),
        active=rng.uniform(size=n_v) < 0.1,
        rhs_u=rng.standard_normal(2 * n_v), rhs_p=rng.standard_normal(n_v),
        lam=0.463, mu=0.417, rtol=1e-10,
        # pressure, constant_k, alpha_eps, G_c, gamma_dt, theta,
        # use_old_pf, decompose_rhs
        scalars=np.array([1e-3, 1e-3, 0.1, 1.0, 0.0, 2.0, 0.0, 1.0]))
    part = halo.device_put_partition(
        halo.build_halo_partition(mesh, inp["lam"], inp["mu"], 8),
        make_device_mesh(8))
    place = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
        make_device_mesh(8), P(halo.AXIS)))
    lp = lambda a: place(halo.global_to_local_p(part, a))
    lu = lambda a: place(halo.global_to_local_u(part, a))
    solve = build_halo_cg(make_device_mesh(8), part, dim=2,
                          with_split=True)
    du, dp, its, _ = solve(
        lu(inp["u"]), lp(inp["phi"]), lp(inp["phi_old"]), lp(inp["phi_old"]),
        place(halo.global_to_local_p(part, inp["active"] * 1.0) > 0.5),
        place(halo.global_to_local_u(part, inp["dirichlet_u"] * 1.0) > 0.5),
        place(halo.global_to_local_p(part, inp["dirichlet_p"] * 1.0) > 0.5),
        lu(inp["rhs_u"]), lp(inp["rhs_p"]), jnp.asarray(inp["rtol"]),
        part.arrays, physics.Scalars(*(jnp.asarray(v)
                                       for v in inp["scalars"])))
    np.savez(os.path.join(OUT, "halo_cg_2d.npz"), **inp,
             n_vertices=n_v, du=halo.local_to_global_u(part, np.asarray(du)),
             dp=halo.local_to_global_p(part, np.asarray(dp)),
             iterations=int(its))
    print(f"halo_cg_2d: {time.perf_counter() - t0:.1f} s, {int(its)} its")


# name -> a writer of its own (the runs above are driver runs)
WRITERS = {"halo_cg_2d": write_halo_cg,
           **{name: (lambda n=name: write_lattice_reference(n))
              for name in LATTICE_RUNS},
           **{name: (lambda n=name: write_lattice_reference(
               n, REPLICATED_RUNS)) for name in REPLICATED_RUNS}}


def main(names):
    os.environ["JAX_PLATFORMS"] = "cpu"
    names = names or list(RUNS) + list(WRITERS)
    devices = max(8 if n in WRITERS else RUNS[n][1].get("n_devices", 1)
                  for n in names)
    if devices > 1:
        # virtual CPU devices, as tests/conftest.py makes them
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devices}").strip()
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    os.makedirs(OUT, exist_ok=True)
    for name in names:
        if name in WRITERS:
            WRITERS[name]()
        else:
            write_reference(name, *RUNS[name])


if __name__ == "__main__":
    main(sys.argv[1:])
