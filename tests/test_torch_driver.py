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


@pytest.mark.parametrize("override,item", [
    (dict(n_local_pre_refine=1), "A10"),
    (dict(assembled_matvec=False, preconditioner="jacobi"), "A12"),
    (dict(test_case="miehe tension"), "A1"),
    (dict(n_local_pre_refine=1, n_devices=4, dof_sharding="lattice"),
     "A11b"),
    (dict(decompose_stress_matrix=1.0), "A1"),
    (dict(outer_solver="simple monolithic"), "A4"),
    (dict(test_case="miehe shear"), "A9"),
    (dict(n_devices=2), "A11"),
])
def test_unported_configurations_raise(override, item):
    """Each raises before any Newton work: at construction, or for the
    linear solve and the halo pool at the first setup or solve of
    run()."""
    p = config.load_parameters(PRM, **{**BENCH, **override})
    with pytest.raises(NotImplementedError, match=item):
        Simulation(p, device="cpu", verbose=False).run()


# formerly refused (refinement, VTU, checkpoints, the direct solve),
# now admitted: one step at global refine 1 on the CPU
ONE_STEP = dict(n_global_pre_refine=1, n_local_pre_refine=0,
                n_refinement_cycles=0, max_no_timesteps=0,
                linear_solver="auto", preconditioner="jacobi",
                mixed_precision_cg=False)


@pytest.mark.parametrize("override", [
    dict(n_local_pre_refine=2),
    dict(n_refinement_cycles=1),
    dict(write_vtu=True),
    dict(checkpoint_every=1),
    dict(linear_solver="direct"),
    dict(linear_solver="direct", preconditioner="gmg",
         mixed_precision_cg=True, n_devices=4, dof_sharding="lattice"),
], ids=["local-pre-refine", "refinement-cycles", "vtu", "checkpoint",
        "direct", "direct-ignored-by-lattice-newton"])
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


def test_sneddon_3d_is_accepted():
    """The 3d Sneddon lattice is part of the slice: the configuration is
    admitted and sets up the 3d mesh (10 roots per axis, refine 1)."""
    p = config.load_parameters(PRM.replace("_2d", "_3d"),
                               **{**BENCH, "n_global_pre_refine": 1})
    assert p.dimension == 3
    sim = Simulation(p, device="cpu", verbose=False)
    assert sim.mesh.dim == 3
    assert (sim.mesh.n_cells, sim.mesh.n_dofs) == (8000, 37044)


@pytest.mark.parametrize("sharding", [
    dict(), dict(n_devices=4, dof_sharding="lattice")],
    ids=["replicated", "lattice"])
@pytest.mark.parametrize("override,item", [
    (dict(linear_solver="cg", n_global_pre_refine=1, preconditioner="jacobi",
          assembled_matvec=False), "not ported"),
    (dict(linear_solver="cg", n_global_pre_refine=1,
          mixed_precision_cg=False), "not ported"),
])
def test_unported_linear_solvers_raise(override, item, sharding):
    """Without mixed precision or the stored element matrices there is
    no lattice hierarchy: the replicated Newton refuses the Galerkin GMG
    (A10) and the matrix-free CG (A12), the sharded mode the halo pool
    (A11b)."""
    p = config.load_parameters(PRM, **{**BENCH, **override, **sharding})
    sim = Simulation(p, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match=item):
        sim.run()


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
