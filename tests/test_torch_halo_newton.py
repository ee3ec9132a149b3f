"""The halo pool's PDAS Newton (cracks_tpu_torch/solvers/halo_newton.py)
and the other multi-shard modes of the driver, against the JAX package:

- the block CG (`build_halo_cg`, the split on) at D = 8 on one seeded
  state against JAX's, stored in tests/torch_reference/halo_cg_2d.npz
  (its while loops take the JAX package about a minute of XLA
  compilation on the CPU; `scripts/torch_reference.py halo_cg_2d`
  rewrites it): the updates to 1e-9 of their largest entry, the
  iteration count of the two blocks together within 2 of JAX's (JAX's
  solve returns only the total; the pool's sums round in another order
  than JAX's psum over 8 devices, and the stop test sits at cg_rtol);
- the driver on the mesh of ``__graft_entry__.dryrun_multichip``'s halo
  step (sneddon_2d_1, one local pre-refinement at phase-field value 0.5:
  453 DoFs, 12 hanging vertices), two load steps at n_devices = 8,
  dof_sharding = lattice, against JAX's halo run stored in
  tests/torch_reference/sneddon_2d_1_halo8.* (about twelve minutes of
  XLA compilation; `scripts/torch_reference.py sneddon_2d_1_halo8`):
  rel 1e-8 and equal Newton iterations per step; against the port's
  replicated run (bulk energy to rel 1e-8,
  ``__graft_entry__.py:214-216``); and the same run on the (2, 4)
  product mesh bit for bit (JAX raises there: ROADMAP C14);
- the replicated cell-axis mode at n_devices = 2 on sneddon_2d_1 (the
  configuration of tests/test_sharding.py:79-94) bit for bit against
  n_devices = 1 and to rel 1e-8 against JAX's n_devices = 2 run;
- the monolithic solver with dof_sharding = lattice at n_devices = 4:
  the replicated fallback, bit for bit against n_devices = 1.
"""

import json
import os

import numpy as np
import pytest
import torch

from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch import config, mesh as tmesh, meshio as tmeshio
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.parallel import halo
from cracks_tpu_torch.solvers.halo_newton import HALO_CG_MAXITER, build_halo_cg

from tests.regression import PRM_DIR, parse_statistics
from tests.test_torch_halo import _mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_reference")
SNEDDON_1 = os.path.join(PRM_DIR, "sneddon_2d_1.prm")
# the dryrun's halo step (cracks_tpu's __graft_entry__.py:186-221) on
# the golden file, two load steps, the Jacobi CG
DRYRUN = dict(n_local_pre_refine=1, value_phase_field_for_refinement=0.5,
              n_refinement_cycles=0, max_no_timesteps=1, linear_solver="cg",
              preconditioner="jacobi", output_dir="")
HALO8 = dict(n_devices=8, dof_sharding="lattice")
COLS = ("Bulk Energy", "Crack Energy")


def test_halo_cg_matches_jax():
    ref = np.load(os.path.join(REF, "halo_cg_2d.npz"))
    # scripts/torch_reference.py::hanging_mesh_2d on the port's forest
    mesh = _mesh(tmesh.Forest, tmeshio.rect_mesh, 2)
    assert mesh.n_vertices == int(ref["n_vertices"])
    part = halo.build_halo_partition(mesh, float(ref["lam"]),
                                     float(ref["mu"]), 8, device=CPU)
    t = lambda k: torch.as_tensor(ref[k], device=CPU)
    lp = lambda x: halo.global_to_local_p(part, x)
    lu = lambda x: halo.global_to_local_u(part, x)
    solve = build_halo_cg(part, with_split=True)
    sc = physics.Scalars(*(torch.tensor(float(v), dtype=torch.float64)
                           for v in ref["scalars"]))
    du, dp, its, _, (it_u, it_p) = solve(
        lu(t("u")), lp(t("phi")), lp(t("phi_old")), lp(t("phi_old")),
        lp(t("active").double()) > 0.5, lu(t("dirichlet_u").double()) > 0.5,
        lp(t("dirichlet_p").double()) > 0.5, lu(t("rhs_u")), lp(t("rhs_p")),
        float(ref["rtol"]), sc)
    assert 0 < max(it_u, it_p) < HALO_CG_MAXITER
    assert abs(its - int(ref["iterations"])) <= 2, (its, ref["iterations"])
    for got, key in ((halo.local_to_global_u(part, du), "du"),
                     (halo.local_to_global_p(part, dp), "dp")):
        want = ref[key]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max(),
                                   err_msg=key)


def _columns(sim):
    d = sim.statistics.data
    return {c: np.array(d[c], dtype=float) for c in COLS}


@pytest.fixture(scope="module")
def dryrun():
    out = {}
    for name, over in (("replicated", {}), ("halo8", HALO8),
                       ("halo8-dcn2", dict(HALO8, mesh_dcn=2))):
        sim = Simulation(config.load_parameters(SNEDDON_1, **DRYRUN, **over),
                         device="cpu", verbose=False)
        sim.run()
        out[name] = sim
    return out


def test_halo_run_matches_jax_table(dryrun):
    sim = dryrun["halo8"]
    assert sim.sys.use_halo_state and not sim.sys.use_lattice_state
    part = sim.sys.halo_partition
    assert part.n_shards == 8 and part.n_loc < part.n_vertices
    assert len(sim.mesh.hang_child) == 12 and sim.mesh.n_dofs == 453
    with open(os.path.join(REF, "sneddon_2d_1_halo8.statistics")) as f:
        names, rows = parse_statistics(f.read())
    with open(os.path.join(REF, "sneddon_2d_1_halo8.effort.json")) as f:
        effort = json.load(f)
    ours = _columns(sim)
    for col in COLS:
        want = np.array([r[names.index(col)] for r in rows], dtype=float)
        np.testing.assert_allclose(ours[col], want, rtol=1e-8, atol=0,
                                   err_msg=col)
    assert ([e[1] for e in sim.solver_effort]
            == [e["newton"] for e in effort])
    rep = _columns(dryrun["replicated"])
    np.testing.assert_allclose(ours["Bulk Energy"], rep["Bulk Energy"],
                               rtol=1e-8, atol=0)


def test_halo_product_mesh_is_the_flat_run(dryrun):
    flat, dcn = dryrun["halo8"], dryrun["halo8-dcn2"]
    assert dcn.sys.use_halo_state and dcn.sys.shard_mesh.shape == (2, 4)
    assert flat.sys.shard_mesh.shape == (8,)
    assert flat.statistics.data == dcn.statistics.data
    assert flat.solver_effort == dcn.solver_effort


def test_replicated_mode_is_the_one_shard_run():
    p = dict(output_dir="", max_no_timesteps=1, n_local_pre_refine=0,
             n_refinement_cycles=0, linear_solver="cg")
    runs = {}
    for nd in (1, 2):
        sim = Simulation(config.load_parameters(SNEDDON_1, **p, n_devices=nd),
                         device="cpu", verbose=False)
        sim.run()
        assert sim.sys.shard_mesh is None and not sim.sys.use_halo_state
        runs[nd] = sim
    assert runs[1].statistics.data == runs[2].statistics.data
    assert runs[1].solver_effort == runs[2].solver_effort
    jsim = JSimulation(jload_parameters(SNEDDON_1, **p, n_devices=2),
                       verbose=False)
    jsim.run()
    ours = _columns(runs[2])
    for col in COLS:
        np.testing.assert_allclose(
            ours[col], np.array(jsim.statistics.data[col], dtype=float),
            rtol=1e-8, atol=0, err_msg=col)


def test_monolithic_lattice_falls_back_to_replicated(capsys):
    p = dict(output_dir="", max_no_timesteps=0, n_local_pre_refine=0,
             n_refinement_cycles=0, outer_solver="simple monolithic",
             gamma_penal=100.0)
    runs = {}
    for over in ({}, dict(n_devices=4, dof_sharding="lattice")):
        sim = Simulation(config.load_parameters(SNEDDON_1, **p, **over),
                         device="cpu", verbose=bool(over))
        sim.run()
        runs[len(over)] = sim
    assert "falling back to replicated DoF vectors" in capsys.readouterr().out
    sim = runs[2]
    assert (sim.sys.shard_mesh is None and not sim.sys.use_halo_state
            and not sim.sys.use_lattice_state)
    assert runs[0].statistics.data == sim.statistics.data
