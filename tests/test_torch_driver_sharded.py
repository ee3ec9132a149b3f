"""The lattice-layout sharded Newton (dof_sharding = lattice) as a whole,
on the Sneddon 2d lattice at refine 2 (41x41 vertices, 5,043 DoFs) with
the settings of tests/test_lattice_newton.py::_sneddon_params, run for
four load steps so that the stationary last step records TCV:

- the port with n_devices=8 (8 row slabs of the 41-row lattice, padded
  to 48 rows, on the CPU) against the JAX package's np8 lattice-sharded
  run on the 8 virtual CPU devices: bulk energy, crack energy and TCV
  to rtol 1e-8, equal Newton iterations per step;
- the port's np8 run against its own n_devices=1, dof_sharding=lattice
  run (the same algorithm with the unsharded fine operator and no pad
  rows): rel 1e-12 in the statistics, equal Newton and linear
  iterations;
- that run against the port's replicated run (flat Newton, the same
  lattice solve): rel 1e-8, equal Newton iterations.

The product mesh (mesh_dcn = 2) runs the np8 run bit for bit; the
replicated mode at n_devices = 2 and the (2, 1) product mesh run; only
shards on distinct devices raise (A11c)."""

import numpy as np
import pytest
import torch

from cracks_tpu.config import Parameters as JParameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.ops import stencil
from cracks_tpu_torch.parallel.sharding import make_shard_mesh

torch.set_num_threads(1)

SNEDDON = dict(
    test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
    poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
    eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
    max_no_newton_steps=50, max_no_line_search_steps=10,
    n_global_pre_refine=2, max_no_timesteps=3, output_dir="",
    linear_solver="cg", preconditioner="gmg", cg_rtol=1e-10,
    mixed_precision_cg=True)
RUNS = {"np8": dict(n_devices=8, dof_sharding="lattice"),
        "np1-lattice": dict(n_devices=1, dof_sharding="lattice"),
        "replicated": dict(n_devices=1)}
COLS = ("Bulk Energy", "Crack Energy", "TCV")


def _stats(sim):
    """{column: float array} of the energies and TCV (TCV only on the
    stationary step)."""
    d = sim.statistics.data
    return {c: np.array([v for v in d[c] if v != ""], dtype=float)
            for c in COLS}


@pytest.fixture(scope="module")
def runs():
    out = {}
    mp = pytest.MonkeyPatch()
    calls = []
    reference = stencil.stencil_matvec_sharded_reference

    def counted(JPs, X, k, mesh):
        calls.append((mesh.n_shards, tuple(JPs[0].shape)))
        return reference(JPs, X, k, mesh)

    try:
        mp.setattr(stencil, "stencil_matvec_sharded_reference", counted)
        for name, kw in RUNS.items():
            calls.clear()
            sim = Simulation(config.Parameters(**SNEDDON, **kw),
                             device="cpu", verbose=False)
            sim.run()
            out[name] = sim
            sim.sharded_products = list(calls)
    finally:
        mp.undo()
    jsim = JSimulation(JParameters(**SNEDDON, **RUNS["np8"]), verbose=False)
    jsim.run()
    out["jax-np8"] = jsim
    return out


def _newton(sim):
    return [e[1] for e in sim.solver_effort]


def test_np8_lattice_matches_jax_np8(runs):
    sim, jsim = runs["np8"], runs["jax-np8"]
    assert jsim.sys.use_lattice_state and sim.sys.use_lattice_state
    assert jsim.sys.lat_gyp == sim.sys.lat_gyp == 48
    a, b = _stats(sim), _stats(jsim)
    assert len(a["TCV"]) == len(b["TCV"]) == 1
    for col in COLS:
        np.testing.assert_allclose(a[col], b[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    assert _newton(sim) == _newton(jsim)
    assert sim.step_cuts == 0


def test_np8_matches_np1_lattice(runs):
    """The two runs differ only in the fine operator (8 per-shard
    products with the halo exchange) and the padded extent gyp."""
    s8, s1 = runs["np8"], runs["np1-lattice"]
    assert s8.sys.shard_mesh.n_shards == 8 and s1.sys.shard_mesh is None
    assert s1.sys.lat_gyp == 41
    # the sharded run went through the per-shard products (8 shards of
    # 6 owned cell rows + 1 halo row; the u block 8x8, the phi block
    # 4x4 per cell), the other not
    assert s1.sharded_products == []
    assert {n for n, _ in s8.sharded_products} == {8}
    assert ({shape for _, shape in s8.sharded_products}
            == {(8, 8, 7, 40), (4, 4, 7, 40)})
    a, b = _stats(s8), _stats(s1)
    for col in COLS:
        np.testing.assert_allclose(a[col], b[col], rtol=1e-12, atol=0,
                                   err_msg=col)
    assert ([e[1:3] for e in s8.solver_effort]
            == [e[1:3] for e in s1.solver_effort])


def test_np1_lattice_matches_replicated(runs):
    s1, rep = runs["np1-lattice"], runs["replicated"]
    assert not rep.sys.use_lattice_state
    a, b = _stats(s1), _stats(rep)
    for col in COLS:
        np.testing.assert_allclose(a[col], b[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    assert _newton(s1) == _newton(rep)


def test_np8_product_mesh_matches_flat(runs):
    """mesh_dcn = 2: the (2, 4) product mesh keeps the flat partition,
    so its run is the np8 run bit for bit."""
    p = config.Parameters(**SNEDDON, **RUNS["np8"], mesh_dcn=2)
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.sys.use_lattice_state and sim.sys.shard_mesh.shape == (2, 4)
    assert sim.statistics.data == runs["np8"].statistics.data
    assert sim.solver_effort == runs["np8"].solver_effort


@pytest.mark.parametrize("override", [
    dict(n_devices=2),                                   # replicated
    dict(n_devices=2, dof_sharding="lattice", mesh_dcn=2),
], ids=["replicated", "mesh_dcn"])
def test_unported_multi_device_modes_raise(override):
    """Formerly refused (A11b), now run to their first step: replicated
    vectors at n_devices = 2 are the one-device replicated run (no shard
    mesh); the (2, 1) product mesh runs the lattice-layout Newton on its
    2 row slabs."""
    p = config.Parameters(**{**SNEDDON, **override, "max_no_timesteps": 0})
    sim = Simulation(p, device="cpu", verbose=False)
    sim.run()
    assert sim.step_cuts == 0 and sim.statistics.data["Bulk Energy"][0] > 0
    if override.get("dof_sharding") == "lattice":
        assert sim.sys.use_lattice_state and sim.sys.shard_mesh.shape == (2, 1)
    else:
        assert sim.sys.shard_mesh is None and not sim.sys.use_lattice_state


def test_shards_on_distinct_devices_raise():
    with pytest.raises(NotImplementedError, match="A11c"):
        make_shard_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    mesh = make_shard_mesh([torch.device("cpu")] * 2)
    assert (mesh.n_shards, mesh.device) == (2, torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        make_shard_mesh([torch.device("cpu")] * 3, dcn=2)
