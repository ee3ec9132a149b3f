"""The port's Miehe tension case, and the pieces of the non-Sneddon
path, against the goldens and the JAX package, device="cpu" (the
three-point and Miehe shear prefixes are in
tests/test_torch_cases_threepoint.py, tests/test_torch_cases_shear.py
and tests/test_torch_cases_shear_adaptive.py).

- `miehe_tension_adaptive_1`, its first 6 rows (891 DoFs, no split in
  the matrix): the golden under the JAX prefix test's tolerances (|d|
  <= 1e-6 or rel <= 1e-8), the JAX run of the same prefix within rel
  1e-8 with equal DoFs and equal Newton and linear iterations per
  solve; its VTU output carries no Sneddon exact phase field;
- `compute_load`, `compute_point_stress` and `compute_point_value` on
  seeded fields over the slit and the three-point meshes, to rel 1e-12;
- the level-capped refinement flags, flag for flag, and the
  mesh-dependent h, k and eps of every non-Sneddon file, exactly;
- the failed-solve rules: a Miehe step is cut by 10, a three-point
  step retried once at the same time with the old phase field, and a
  second failure propagates;
- the refusals that remain (gmg with mixed precision on the uniformly
  refined slit mesh across devices; the monolithic solver on the
  matrix-free operator now runs its first step), and the formerly
  refused cases that now run (the multiple-crack cases, gmg without
  mixed precision on the slit and the three-point meshes, held to the
  JAX runs);
- C3: the device affine geometry on a skewed (parallelogram) mesh, held
  to the JAX package's and to the host tabulation."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import meshio as jmeshio, problems as jproblems
from cracks_tpu import qoi as jqoi
from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.driver import SolutionState as JSolutionState
from cracks_tpu.driver import run_prm as jrun_prm
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.ops import physics as jphys
from cracks_tpu_torch import config, fem, meshio, problems, qoi
from cracks_tpu_torch.driver import Simulation, SolutionState, run_prm
from cracks_tpu_torch.mesh import Forest
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.solvers import newton
from cracks_tpu_torch.solvers.newton import NoConvergence, NewtonLog

from .regression import (MESH_DIR, PARAMS_DIR, PRM_DIR, load_golden,
                         parse_statistics)

torch.set_num_threads(1)

CASE_PRMS = ["miehe_shear_1", "miehe_shear_2", "miehe_tension_adaptive_1",
             "threepoint_1"]


def _prm(name):
    return os.path.join(PRM_DIR, f"{name}.prm")


def _table(sim):
    return parse_statistics(sim.statistics.write_text())[1]


def assert_golden_prefix(sim, golden_name, n_rows, atol=1e-6, rtol=1e-8):
    """tests/test_regression_adaptive.py's _prefix_match."""
    ours = _table(sim)[:n_rows]
    golden = load_golden(golden_name)[1][:n_rows]
    assert ours.shape == golden.shape
    diff = np.abs(ours - golden)
    rel = diff / np.maximum(np.abs(golden), 1e-300)
    ok = (diff <= atol) | (rel <= rtol)
    assert ok.all(), (ours[~ok.all(axis=1)], golden[~ok.all(axis=1)])


def assert_matches_jax_run(sim, sim_j, rtol=1e-8):
    """Equal tables within rtol, equal DoF columns, and per solve (a
    redone step solves twice) equal step numbers and Newton and linear
    iterations, with no time-step cut."""
    ours, ref = _table(sim), _table(sim_j)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0)
    assert sim.statistics.data["DoFs"] == sim_j.statistics.data["DoFs"]
    assert ([e[:3] for e in sim.solver_effort]
            == [tuple(e[:3]) for e in sim_j.solver_effort])
    assert sim.step_cuts == 0 and sim.old_pf_retries == 0


def test_miehe_tension_prefix(tmp_path):
    sim, _ = run_prm(_prm("miehe_tension_adaptive_1"), device="cpu",
                     max_no_timesteps=5, output_dir=str(tmp_path),
                     write_vtu=True)
    sim_j, _ = jrun_prm(_prm("miehe_tension_adaptive_1"),
                        max_no_timesteps=5, output_dir="")
    assert_golden_prefix(sim, "miehe_tension_adaptive_1.statistics", 6)
    assert_matches_jax_run(sim, sim_j)
    assert sim.statistics.data["DoFs"] == [891] * 6
    vtus = sorted(glob.glob(str(tmp_path / "*.vtu")))
    assert len(vtus) == 7
    text = open(vtus[-1]).read()
    assert "phasefield" in text and "exact_phi" not in text


def _seeded_meshes():
    """(name, port mesh, JAX mesh): the slit mesh at refine 2 and the
    three-point mesh at refine 1."""
    out = []
    for name, read, jread, refine in (
            ("slit", lambda: meshio.read_ucd(
                os.path.join(MESH_DIR, "unit_slit.inp"), dim=2),
             lambda: jmeshio.read_ucd(
                 os.path.join(MESH_DIR, "unit_slit.inp"), dim=2), 2),
            ("threepoint", lambda: problems.recolor_threepoint_boundaries(
                meshio.read_msh(os.path.join(MESH_DIR, "threepoint.msh"))),
             lambda: jproblems.recolor_threepoint_boundaries(
                 jmeshio.read_msh(os.path.join(MESH_DIR, "threepoint.msh"))),
             1)):
        f, jf = Forest(read()), JForest(jread())
        f.refine_global(refine)
        jf.refine_global(refine)
        out.append((name, f.extract(), jf.extract()))
    return out


@pytest.mark.parametrize("name,mesh,jmesh", _seeded_meshes(),
                         ids=["slit", "threepoint"])
def test_load_and_point_functionals_match_jax(name, mesh, jmesh):
    np.testing.assert_array_equal(mesh.cell_coords, jmesh.cell_coords)
    rng = np.random.default_rng(3)
    u = rng.normal(scale=1e-3, size=(mesh.n_vertices, 2))
    phi = rng.uniform(0.0, 1.0, mesh.n_vertices)
    lam = rng.uniform(1e3, 2e3, mesh.n_cells)
    mu = rng.uniform(5e2, 1e3, mesh.n_cells)
    for bid in np.unique(mesh.bface_id):
        load = qoi.compute_load(mesh, u, lam, mu, boundary_id=int(bid))
        ref = jqoi.compute_load(jmesh, u, lam, mu, boundary_id=int(bid))
        np.testing.assert_allclose(load, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(qoi.compute_load(mesh, u, lam, mu, 99),
                                  np.zeros(2))
    lo, hi = mesh.vert_coords.min(axis=0), mesh.vert_coords.max(axis=0)
    points = [(0.0, 2.0), tuple(0.3 * lo + 0.7 * hi), tuple(0.5 * (lo + hi)),
              tuple(hi + 1.0)]
    for pt in points:
        ps = qoi.compute_point_stress(mesh, u, pt)
        assert ps == pytest.approx(jqoi.compute_point_stress(jmesh, u, pt),
                                   rel=1e-12, abs=1e-15)
        v = qoi.compute_point_value(mesh, phi, pt)
        assert np.allclose(v, jqoi.compute_point_value(jmesh, phi, pt),
                           rtol=1e-12, atol=1e-15)
        for comp in (0, 1):
            assert qoi.compute_point_value(mesh, u, pt, comp) == \
                pytest.approx(jqoi.compute_point_value(jmesh, u, pt, comp),
                              rel=1e-12, abs=1e-15)
    assert qoi.compute_point_stress(mesh, u, tuple(hi + 1.0)) == -1e100


@pytest.mark.parametrize("name,mesh,jmesh", _seeded_meshes(),
                         ids=["slit", "threepoint"])
def test_cod_array_matches_jax(name, mesh, jmesh):
    """The bucketed COD profile (its 2d integrand through the adjugate
    of J) against the JAX package's per-point inverse, on seeded fields
    of the slit and the (non-affine) three-point cells."""
    rng = np.random.default_rng(5)
    u = rng.normal(scale=1e-3, size=(mesh.n_vertices, 2))
    phi = rng.uniform(0.0, 1.0, mesh.n_vertices)
    xs, vals, exact = qoi.compute_cod_array(mesh, u, phi)
    jxs, jvals, jexact = jqoi.compute_cod_array(jmesh, u, phi)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(exact, jexact)
    assert np.abs(jvals).max() > 0
    np.testing.assert_allclose(vals, jvals, rtol=0,
                               atol=1e-12 * np.abs(jvals).max())


def test_level_capped_flags_match_jax():
    """miehe_shear_1 (level cap 3 + 1 = 4): refine the cells left of
    x = 0.5 to the cap, then flag by a seeded phase field; the capped
    cells drop out, flag for flag as in the JAX driver."""
    kw = dict(output_dir="")
    sim = Simulation(config.load_parameters(_prm("miehe_shear_1"), **kw),
                     device="cpu", verbose=False)
    sim_j = JSimulation(jload_parameters(_prm("miehe_shear_1"), **kw),
                        verbose=False)
    for s in (sim, sim_j):
        flags = s.mesh.cell_coords.mean(axis=1)[:, 0] < 0.5
        s.mesh, _, _ = s.forest.refine_and_transfer(
            flags, s.mesh, [np.zeros(s.mesh.n_vertices)])
    np.testing.assert_array_equal(sim.forest.level, sim_j.forest.level)
    assert (sim.forest.level == 4).any() and (sim.forest.level == 3).any()
    rng = np.random.default_rng(5)
    n_v = sim.mesh.n_vertices
    u = rng.normal(scale=1e-3, size=2 * n_v)
    phi = rng.uniform(0.0, 1.0, n_v)
    state = SolutionState(*(torch.as_tensor(a) for a in (u, phi, u, phi,
                                                          phi)))
    state_j = JSolutionState(*(jnp.asarray(a) for a in (u, phi, u, phi,
                                                        phi)))
    flags = sim._refine_flags(state)
    np.testing.assert_array_equal(flags, np.asarray(
        sim_j._refine_flags(state_j)))
    below = (phi[sim.mesh.cell2vert] < 0.8).any(axis=1)
    assert (below & (sim.forest.level == 4)).any()
    np.testing.assert_array_equal(flags, below & (sim.forest.level != 4))


@pytest.mark.parametrize("path", [_prm(n) for n in CASE_PRMS] + [
    os.path.join(PARAMS_DIR, "parameters_miehe_shear_adaptive.prm")],
    ids=CASE_PRMS + ["shipped_miehe_shear"])
def test_mesh_dependent_parameters_match_jax(path):
    sim = Simulation(config.load_parameters(path, output_dir=""),
                     device="cpu", verbose=False)
    sim_j = JSimulation(jload_parameters(path, output_dir=""),
                        verbose=False)
    assert sim.coarse_max_diameter == sim_j.coarse_max_diameter
    sim.determine_mesh_dependent_parameters()
    sim_j.determine_mesh_dependent_parameters()
    assert ((sim.min_cell_diameter, sim.constant_k, sim.alpha_eps)
            == (sim_j.min_cell_diameter, sim_j.constant_k,
                sim_j.alpha_eps))
    p = sim.p
    assert sim.min_cell_diameter == sim.coarse_max_diameter * 2.0 ** -(
        p.n_global_pre_refine + p.n_refinement_cycles + p.n_local_pre_refine)
    assert sim.mesh.n_dofs == sim_j.mesh.n_dofs


@pytest.mark.parametrize("case,retried", [("miehe_shear_2", False),
                                          ("threepoint_1", True)])
def test_failed_solve_rules(case, retried, monkeypatch):
    """One failed solve: Miehe cuts the step by 10 and restarts;
    three-point bending retries at the same time with the old phase
    field; there a second failure propagates."""
    sim = Simulation(config.load_parameters(_prm(case), output_dir=""),
                     device="cpu", verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    n_v = sim.mesh.n_vertices
    z = lambda n: torch.zeros(n, dtype=torch.float64)
    state = SolutionState(z(2 * n_v), z(n_v), z(2 * n_v), z(n_v), z(n_v))
    calls, fail = [], [True]

    def solve(sys, st, time, verbose=True):
        calls.append((time, sys.scalars.use_old_pf.item()))
        if fail and fail.pop(0):
            raise NoConvergence()
        st.last_log = NewtonLog()

    monkeypatch.setattr(newton, "newton_active_set", solve)
    dt = sim.timestep
    sim._solve_step(state)
    if retried:
        assert calls == [(dt, 0.0), (dt, 1.0)]
        assert (sim.old_pf_retries, sim.step_cuts, sim.time) == (1, 0, dt)
        fail[:] = [True, True]
        with pytest.raises(NoConvergence):
            sim._solve_step(state)
    else:
        assert calls == [(dt, 0.0), (pytest.approx(dt / 10), 0.0)]
        assert (sim.old_pf_retries, sim.step_cuts) == (0, 1)
        assert sim.timestep == dt / 10


@pytest.mark.parametrize("case,override,item", [
    # the monolithic solver with the matrix-free operator: runs
    ("miehe_shear_1", dict(outer_solver="simple monolithic",
                           linear_solver="cg", assembled_matvec=False),
     None),
    # gmg + mixed precision on the uniformly refined slit mesh (the seam
    # lattice, ported) with replicated vectors across devices
    ("miehe_tension_adaptive_1", dict(
        preconditioner="gmg", linear_solver="cg", mixed_precision_cg=True,
        n_devices=2), "A11b"),
], ids=["miehe_shear_1-override0-A12",
        "miehe_tension_adaptive_1-override1-A11b"])
def test_remaining_refusals(case, override, item):
    """Formerly refused: each runs to its first step.  The matrix-free
    case (item None) takes the matrix-free CG; the seam lattice with
    replicated vectors on 2 devices (A11b) is the one-device run of the
    replicated Newton, no shard mesh."""
    p = config.load_parameters(_prm(case), output_dir="",
                               max_no_timesteps=0, **override)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.step_cuts == 0 and sim.statistics.data["Bulk Energy"][0] > 0
    if item is None:
        assert newton.check_linear_solver(sim.sys) == "matrix-free"
        return
    assert sim.sys.shard_mesh is None and not sim.sys.use_lattice_state
    assert sim.sys.lattice_hierarchy.seam is not None
    assert newton.check_linear_solver(sim.sys) == "lattice"


@pytest.mark.parametrize("case,override", [
    ("miehe_shear_1", dict(test_case="multiple homo")),
    ("miehe_shear_1", dict(test_case="multiple het")),
    ("miehe_tension_adaptive_1", dict(preconditioner="gmg",
                                      linear_solver="cg")),
    # one global refinement: the forest has a coarser level to take
    ("threepoint_1", dict(preconditioner="gmg", linear_solver="cg",
                          n_global_pre_refine=1)),
], ids=["multiple-homo", "multiple-het", "slit-galerkin-f64",
        "three-point-galerkin-f64"])
def test_formerly_refused_cases_run(case, override):
    """The multiple-crack cases and gmg without mixed precision on the
    slit and the three-point meshes (the Galerkin hierarchy, as in
    JAX), one step; the gmg runs equal the JAX runs within rel 1e-8
    with equal Newton iterations."""
    p = config.load_parameters(_prm(case), output_dir="",
                               max_no_timesteps=0, **override)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.step_cuts == 0 and sim.statistics.data["Bulk Energy"][0] >= 0
    if "preconditioner" not in override:
        return
    assert sim.sys.galerkin_hierarchy is not None
    sim_j = JSimulation(jload_parameters(_prm(case), output_dir="",
                                         max_no_timesteps=0, **override),
                        verbose=False)
    sim_j.run()
    dt, dj = sim.statistics.data, sim_j.statistics.data
    assert dt["DoFs"] == dj["DoFs"]
    for col in ("Bulk Energy", "Crack Energy"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-8, atol=0)
    assert ([e[1] for e in sim.solver_effort]
            == [e[1] for e in sim_j.solver_effort])


def test_affine_geometry_on_skewed_mesh_matches_jax():
    """ROADMAP C3: on parallelogram cells the device tabulation sums two
    nonzero products per entry.  The port's cell core equals the JAX
    package's within 4 ulp of the largest gradient, and both the host
    tabulation (fem.cell_geometry) within the same."""
    coarse = meshio.rect_mesh([0.0, 0.0], [3.0, 2.0], [3, 2])
    jcoarse = jmeshio.rect_mesh([0.0, 0.0], [3.0, 2.0], [3, 2])
    for c in (coarse, jcoarse):
        c.vertices[:, 0] += 0.37 * c.vertices[:, 1]
        c.vertices[:, 1] += 0.11 * c.vertices[:, 0]
    f, jf = Forest(coarse), JForest(jcoarse)
    f.refine_global(2)
    jf.refine_global(2)
    mesh, jmesh = f.extract(), jf.extract()
    t = fem.element_tables(2)
    geo = fem.affine_cell_jacobians(mesh.cell_coords, t)
    assert geo is not None
    assert (np.abs(geo[1][:, 0, 1]) > 0).all()
    lam, mu = np.full(mesh.n_cells, 2.0), np.full(mesh.n_cells, 1.0)
    core = physics.build_cell_core(mesh, lam, mu, device="cpu")
    jcore = jphys.build_cell_core(jmesh, lam, mu)
    JxW_h, grads_h = fem.cell_geometry(mesh.cell_coords, t)
    g = core.grads.numpy()
    tol = 4 * np.finfo(np.float64).eps * np.abs(grads_h).max()
    np.testing.assert_allclose(g, np.asarray(jcore.grads), rtol=0, atol=tol)
    np.testing.assert_allclose(g, grads_h, rtol=0, atol=tol)
    np.testing.assert_allclose(core.JxW.numpy(), np.asarray(jcore.JxW),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(core.JxW.numpy(), JxW_h, rtol=1e-14, atol=0)
