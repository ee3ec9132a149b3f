"""The slice as a whole: the PyTorch port's Simulation (device="cpu")
against the JAX Simulation on the Sneddon 2d bench configuration at
refine 3 (19,683 DoFs, two load steps, cg + gmg + mixed-precision CG,
cg_rtol 1e-8).  The JAX side runs its split lattice solve (the
algorithm the port implements) by setting FUSED_SOLVE_MAX_DOFS to 0.

Bulk and crack energy agree per step to rel 1e-8 (the JAX split and
fused variants agree to 1e-9; the f32 CG sums in another order), with
equal DoFs and equal Newton iterations per step."""

import os

import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu.config import load_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch import __main__ as cli
from cracks_tpu_torch.driver import Simulation, run_prm
from cracks_tpu_torch import config
from cracks_tpu_torch.solvers import newton

torch.set_num_threads(1)

PRM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params", "parameters_sneddon_2d.prm")
# bench.py's Sneddon settings (_make_params/_tpu_overrides), refine 3
BENCH = dict(n_global_pre_refine=3, n_local_pre_refine=0,
             n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
             linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
             cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)


def test_sneddon_refine3_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
    sim_j = JSimulation(load_parameters(PRM, **BENCH), verbose=False)
    sim_j.run()
    out = tmp_path / "out"
    sim, state = run_prm(PRM, device="cpu", **{**BENCH,
                                                "output_dir": str(out)})
    dj, dt = sim_j.statistics.data, sim.statistics.data
    assert dt["DoFs"] == dj["DoFs"] == [19683, 19683]
    for col in ("Bulk Energy", "Crack Energy"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    assert ([e[1] for e in sim.solver_effort]
            == [e[1] for e in sim_j.solver_effort])
    assert sim.step_cuts == 0
    assert state.u.dtype == torch.float64 and state.u.device.type == "cpu"
    text = (out / "statistics").read_text()
    assert "Bulk Energy" in text and (out / "parameters.prm").exists()


def test_device_is_explicit():
    p = config.load_parameters(PRM, **BENCH)
    with pytest.raises(TypeError):
        Simulation(p)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(p, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([PRM, "n_global_pre_refine=1", "n_local_pre_refine=0",
                  "n_refinement_cycles=0"])


# every case now runs (the matrix-free operator, PR 12; the multi-shard
# modes on one device): each keeps its id and runs the configuration to
# its first step, cut in size (the matrix-free cases at refine 2 and 0:
# on the CPU the matrix-free V-cycle costs a thousand jvps per iteration,
# and without a coarser level the solve is the matrix-free Jacobi CG, as
# in JAX), and asserts the mode that engaged: the linear solve, the halo
# pool, or replicated DoF vectors (no shard mesh)
FIRST_STEP_RUNS = {
    "override0-A12": (dict(n_global_pre_refine=2), "matrix-free"),
    "override1-A11b": (dict(n_global_pre_refine=1), "halo"),
    "override2-A12": (dict(n_global_pre_refine=0), "matrix-free"),
    "override3-A11b": (dict(n_global_pre_refine=2), "replicated"),
    "override4-A11": (dict(n_global_pre_refine=2), "replicated")}


@pytest.mark.parametrize("override,item", [
    (dict(assembled_matvec=False, preconditioner="jacobi"), None),
    # a hanging-node mesh on 4 shards: the owned+ghost halo pool
    (dict(n_local_pre_refine=1, n_devices=4, dof_sharding="lattice"),
     "A11b"),
    # the monolithic solver with the matrix-free operator
    (dict(outer_solver="simple monolithic", assembled_matvec=False), None),
    # the (2, 1) product mesh with replicated vectors (the seam lattice
    # replicated on 2 devices runs in test_torch_cases.py; this file's
    # Sneddon physics does not converge on the Miehe shear mesh)
    (dict(n_devices=2, mesh_dcn=2), "A11b"),
    # the replicated cell-axis mode
    (dict(n_devices=2), "A11"),
], ids=["override0-A12", "override1-A11b", "override2-A12", "override3-A11b",
        "override4-A11"])
def test_unported_configurations_raise(override, item, request):
    """Formerly refused configurations (the ROADMAP item in each id):
    each runs to its first step, cut in size, and engages its mode."""
    cut, mode = FIRST_STEP_RUNS[request.node.callspec.id]
    p = config.load_parameters(PRM, **{**BENCH, **override, **cut,
                                       "max_no_timesteps": 0})
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.step_cuts == 0 and len(sim.solver_effort) == 1
    assert sim.statistics.data["Bulk Energy"][0] > 0
    if mode == "halo":
        assert sim.sys.use_halo_state and sim.sys.shard_mesh.n_shards == 4
        assert len(sim.mesh.hang_child) > 0
    elif mode == "replicated":
        assert sim.sys.shard_mesh is None
        assert not (sim.sys.use_halo_state or sim.sys.use_lattice_state)
        assert newton.check_linear_solver(sim.sys) == "lattice"
    else:
        assert newton.check_linear_solver(sim.sys) == mode


# formerly refused (refinement, VTU, checkpoints, the direct solve, the
# multiple-crack cases, the Galerkin GMG), now admitted: one step at
# global refine 1 on the CPU (gmg on the three-point and the slit mesh,
# which this file's Sneddon physics does not drive to convergence in
# either package, runs with their own files in
# tests/test_torch_cases.py)
ONE_STEP = dict(n_global_pre_refine=1, n_local_pre_refine=0,
                n_refinement_cycles=0, max_no_timesteps=0,
                linear_solver="auto", preconditioner="jacobi",
                mixed_precision_cg=False)
GMG = dict(linear_solver="cg", preconditioner="gmg")


@pytest.mark.parametrize("override", [
    dict(n_local_pre_refine=2),
    dict(n_refinement_cycles=1),
    dict(write_vtu=True),
    dict(checkpoint_every=1),
    dict(linear_solver="direct"),
    dict(linear_solver="direct", preconditioner="gmg",
         mixed_precision_cg=True, n_devices=4, dof_sharding="lattice"),
    dict(n_local_pre_refine=1, mixed_precision_cg=True, **GMG),
    # the unit square at refine 1 has no interior vertex
    dict(test_case="multiple homo", n_global_pre_refine=3),
    dict(test_case="multiple het", n_global_pre_refine=3),
    dict(**GMG),
], ids=["local-pre-refine", "refinement-cycles", "vtu", "checkpoint",
        "direct", "direct-ignored-by-lattice-newton",
        "local-pre-refine-galerkin-split", "multiple-homo", "multiple-het",
        "uniform-galerkin-f64"])
def test_formerly_refused_configurations_run(override, tmp_path):
    p = config.load_parameters(PRM, **{**BENCH, **ONE_STEP, **override,
                                       "output_dir": str(tmp_path)})
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert len(sim.solver_effort) == 1 and sim.step_cuts == 0
    assert sim.statistics.data["Bulk Energy"][0] > 0
    if "n_local_pre_refine" in override:
        assert len(sim.mesh.hang_child) > 0
        assert sim.sys.lattice_hierarchy is None
    if override.get("write_vtu"):
        assert (tmp_path / "solution_00000.vtu").exists()
        assert "solution_00001.vtu" in (tmp_path / "solution.pvd").read_text()
    if "checkpoint_every" in override:
        assert (tmp_path / "checkpoint.npz").exists()
    if override.get("dof_sharding") == "lattice":
        assert sim.sys.use_lattice_state
    elif override.get("linear_solver") == "direct":
        assert all(e[2] == e[1] for e in sim.solver_effort)
    elif override.get("preconditioner") == "gmg":
        # the Galerkin GMG: the block CG, or the split solve with mixed
        # precision
        assert sim.sys.galerkin_hierarchy is not None
        assert sim.sys.lattice_hierarchy is None
        assert newton.check_linear_solver(sim.sys) == "galerkin"
        assert sim.solver_effort[0][2] > sim.solver_effort[0][1]


def test_sneddon_3d_is_accepted():
    """The 3d Sneddon lattice is part of the slice: the configuration is
    admitted and sets up the 3d mesh (10 roots per axis, refine 1)."""
    p = config.load_parameters(PRM.replace("_2d", "_3d"),
                               **{**BENCH, "n_global_pre_refine": 1})
    assert p.dimension == 3
    sim = Simulation(p, device="cpu", verbose=False)
    assert sim.mesh.dim == 3
    assert (sim.mesh.n_cells, sim.mesh.n_dofs) == (8000, 37044)


SHARDED = dict(n_devices=4, dof_sharding="lattice")


@pytest.mark.parametrize("override,item,sharding", [
    (dict(linear_solver="cg", n_global_pre_refine=1, preconditioner="jacobi",
          assembled_matvec=False), None, {}),
    (dict(linear_solver="cg", n_global_pre_refine=1, preconditioner="jacobi",
          assembled_matvec=False), "A11b", SHARDED),
    (dict(linear_solver="cg", n_global_pre_refine=1,
          mixed_precision_cg=False), "A11b", SHARDED),
], ids=["matrix-free-replicated", "matrix-free-lattice",
        "no-mixed-precision-lattice"])
def test_unported_linear_solvers_raise(override, item, sharding):
    """Without mixed precision or the stored element matrices there is
    no lattice hierarchy: the replicated Newton takes the matrix-free CG
    (item None), and the sharded mode the owned+ghost halo pool (A11b),
    whose solve is its own Jacobi block CG whatever the linear solver.
    Each runs to its first step.  (gmg without mixed precision on the
    replicated Newton takes the Galerkin hierarchy:
    test_formerly_refused_configurations_run.)"""
    p = config.load_parameters(PRM, **{**BENCH, **override, **sharding,
                                       "max_no_timesteps": 0})
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.step_cuts == 0 and len(sim.solver_effort) == 1
    if item is None:
        assert newton.check_linear_solver(sim.sys) == "matrix-free"
    else:
        assert sim.sys.use_halo_state and sim.sys.halo_partition.n_shards == 4
        assert (sim.sys.galerkin_hierarchy is None
                and sim.sys.hierarchy is None)
        assert sim.statistics.data["Bulk Energy"][0] > 0


def test_cli_parses_overrides(monkeypatch):
    seen = {}

    def fake_run_prm(path, *, device, **overrides):
        seen.update(path=path, device=device, **overrides)

    monkeypatch.setattr("cracks_tpu_torch.driver.run_prm", fake_run_prm)
    assert cli.main([PRM, "n_global_pre_refine=6", "mixed_precision_cg=False",
                     "cg_rtol=1e-8", "device=cpu"]) == 0
    assert seen == dict(path=PRM, device="cpu", n_global_pre_refine=6,
                        mixed_precision_cg=False, cg_rtol=1e-8)
    with pytest.raises(ValueError):
        cli.main([PRM, "mixed_precision_cg=maybe"])
