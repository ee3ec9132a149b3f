"""The lattice layout on W processes (ROADMAP A11d): W spawned gloo
ranks on the CPU, one torch thread each, one launch per W that runs all
its cases; each is held bit for bit to the same case in one process,
run meanwhile (`parallel/dist.py`, `parallel/sharding.py::Slab`).

- the plain sharded product (`stencil_matvec_sharded` with the carrier
  of `pad_jac_sharded`, whose halo cell row comes from the rank below)
  and `ppermute_rows` on seeded inputs, 2d and 3d, at D = 4 on W = 2
  and D = 8 on W = 4: each rank's rows equal the one-process ones;
- the Sneddon 2d lattice at refine 3 and D = 4 (rows_loc 21, odd, so
  rank boundaries fall on odd rows; 3 of the 4 GMG levels split by
  slab, the coarsest whole): the first u-block CG pass of load step 0,
  its residual, one V-cycle of it, the pass's iterate, iterations and
  best residual, on W = 2 and 4;
- the Sneddon 2d lattice of tests/test_torch_driver_sharded.py (refine
  2, 5,043 DoFs, four load steps) at D = 8 on W = 2 and 4, and Sneddon
  3d at refine 1 (37,044 DoFs, load step 0) at D = 4 on W = 2: every
  rank's statistics and Newton and linear iterations equal every other
  rank's and the one-process D-shard run's, and (as that run's) the
  JAX package's np8 / np4 lattice run to rtol 1e-8 with equal Newton
  iterations (tests/torch_reference/sneddon_{2d_lattice_np8,
  3d_lattice_np4}.json, written by scripts/torch_reference.py, so that
  no rank imports JAX).

The module imports no JAX: the spawned ranks import it to unpickle
what they run.
"""

import concurrent.futures
import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.ops import stencil
from cracks_tpu_torch.parallel import dist, sharding
from cracks_tpu_torch.solvers import lattice

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "tests", "torch_reference")
SNEDDON_3D = os.path.join(REPO, "params", "parameters_sneddon_3d.prm")
# tests/test_torch_driver_sharded.py's SNEDDON
SNEDDON = dict(
    test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
    poisson_ratio_nu=0.2, E_modulus=1.0, k_reg_expr="1e-8*h",
    eps_reg_expr="2.0*h", lower_bound_newton_residual=1e-7,
    max_no_newton_steps=50, max_no_line_search_steps=10,
    n_global_pre_refine=2, max_no_timesteps=3, output_dir="",
    linear_solver="cg", preconditioner="gmg", cg_rtol=1e-10,
    mixed_precision_cg=True)
LATTICE = dict(dof_sharding="lattice")
# name -> (the parameters' overrides, the JAX table or None, the torch
# threads of each process that runs it: the 3d case, the longest, takes
# two, in one process as on the ranks, so that whatever a thread count
# may change is the same in both)
RUNS = {
    "2d-D8": (dict(SNEDDON, n_devices=8, **LATTICE),
              "sneddon_2d_lattice_np8", 1),
    "3d-D4": (dict(SNEDDON, dimension=3, n_global_pre_refine=1,
                   max_no_timesteps=0, n_devices=4, **LATTICE),
              "sneddon_3d_lattice_np4", 2),
    # step 0 at refine 3, D = 4: the first u-block CG pass is captured
    "pass-D4": (dict(SNEDDON, n_global_pre_refine=3, max_no_timesteps=0,
                     n_devices=4, **LATTICE), None, 1),
}
# world -> (the product cases' D, the runs)
WORLDS = {2: (4, ["3d-D4", "2d-D8", "pass-D4"]),
          4: (8, ["2d-D8", "pass-D4"])}
COLS = ("Bulk Energy", "Crack Energy", "TCV")
# (dim, k, block rows lo, hi, cells): every rank holds rows on D = 8
PRODUCTS = [(2, 2, 0, 8, (20, 9)), (2, 1, 8, 12, (20, 9)),
            (3, 3, 0, 24, (13, 4, 5)), (3, 1, 24, 32, (13, 4, 5))]


# ---------------------------------------------------------------------------
# what the ranks (and the one-process runs) run
# ---------------------------------------------------------------------------

def _inputs(dim, cells):
    rng = np.random.default_rng(11 + dim)
    ndl = 2 ** dim * (dim + 1)
    jac = torch.as_tensor(rng.standard_normal((ndl, ndl) + cells))
    X = torch.as_tensor(rng.standard_normal((dim,) + tuple(
        c + 1 for c in cells)))
    return jac, X


def _products(ranks, D):
    """Each PRODUCTS case's product on this process's rows (rank r's
    X rows and J cells from first * rows_loc), and `ppermute_rows` of
    one seeded row per shard both ways."""
    mesh = sharding.make_shard_mesh(["cpu"] * D, ranks=ranks)
    out = []
    for dim, k, lo, hi, cells in PRODUCTS:
        jac, X = _inputs(dim, cells)
        g0 = X.shape[1]
        rl = mesh.rows_loc(g0)
        r0 = mesh.first * rl
        r1 = min(r0 + mesh.n_local * rl, g0)
        JP = stencil.pad_jac_sharded(jac[:, :, r0:r1].contiguous(), lo, hi,
                                     lo, hi, mesh, rows_loc=rl)
        out.append(stencil.stencil_matvec_sharded(
            JP, X[:k, r0:r1].contiguous(), k, mesh))
    rows = torch.arange(D * 3, dtype=torch.float64).reshape(D, 1, 3)
    mine = rows[mesh.first:mesh.first + mesh.n_local]
    up, down = torch.full_like(mine, -1.0), torch.full_like(mine, -1.0)
    sharding.ppermute_rows(list(mine), 1, list(up), mesh)
    sharding.ppermute_rows(list(mine), -1, list(down), mesh)
    return out, up, down


def _capture_first_pass(record):
    """Wrap `lattice._cg_pass32` so that its first u-block call records
    the owned rows of its residual, of one V-cycle of it and of its
    iterate, its iterations and best residual, and the hierarchy's
    split."""
    real = lattice._cg_pass32

    def captured(levels, coarse32, R0, tol2, **kw):
        out = real(levels, coarse32, R0, tol2, **kw)
        if not record and kw["which"] == "u":
            k, lo, hi = lattice._blk("u", kw["dim"])
            M = lattice.make_vcycle(levels, lo, hi, k, coarse32,
                                    slabs=kw["slabs"],
                                    n_split=kw["n_split"])
            sl = kw["slabs"][-1]
            record.update(rows=(sl.a, sl.b), R0=R0.clone(), Z=M(R0),
                          X=out[0].clone(), its=out[1], rr=out[2],
                          n_split=kw["n_split"],
                          n_levels=len(levels))
        return out
    return real, captured


def _run(ranks, name):
    over, _, threads = RUNS[name]
    prm = (config.load_parameters(SNEDDON_3D, **over)
           if over.get("dimension") == 3 else config.Parameters(**over))
    record = {}
    real, captured = _capture_first_pass(record)
    lattice._cg_pass32 = captured
    torch.set_num_threads(threads)
    try:
        sim = Simulation(prm, device="cpu", verbose=False)
        sim.run()
    finally:
        lattice._cg_pass32 = real
        torch.set_num_threads(1)
    return dict(stats=sim.statistics.data, effort=sim.solver_effort,
                cuts=sim.step_cuts, lattice=sim.sys.use_lattice_state,
                n_split=sim.sys.lattice_hierarchy.n_split,
                n_local=(None if sim.sys.shard_mesh is None
                         else sim.sys.shard_mesh.n_local),
                first_pass=record)


def _rank(ranks, D, names):
    return _products(ranks, D), {n: _run(ranks, n) for n in names}


def _one_process(names):
    return {n: _run(None, n) for n in names}


# ---------------------------------------------------------------------------

_LAUNCHED = {}


def _launched(tmp_path):
    """Both worlds' launches, the one-process 2d runs in a spawned worker
    and the one-process 3d run (the longest) here, side by side, once
    per module."""
    if not _LAUNCHED:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool, \
                concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=ctx) as worker:
            one2d = worker.submit(_one_process,
                                  [n for n in RUNS if n != "3d-D4"])
            ranked = {W: pool.submit(dist.launch, _rank, W,
                                     args=(D, names), device="cpu",
                                     rendezvous_dir=str(tmp_path),
                                     deadline_s=400)
                      for W, (D, names) in WORLDS.items()}
            one = dict(_one_process(["3d-D4"]), **one2d.result())
            _LAUNCHED.update(one=one, ranked={W: f.result()
                                              for W, f in ranked.items()})
    return _LAUNCHED


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_products_and_ppermute_match_one_process(world, tmp_path):
    D = WORLDS[world][0]
    outs = _launched(tmp_path)["ranked"][world]
    assert len(outs) == world
    one = _products(None, D)
    for rank, ((ys, up, down), _) in enumerate(outs):
        for (dim, k, _, _, cells), y, y1 in zip(PRODUCTS, ys, one[0]):
            rl = -(-(cells[0] + 1) // D)
            r0 = rank * (D // world) * rl
            assert torch.equal(y, y1[:, r0:r0 + y.shape[1]]), (dim, k, rank)
            assert y.shape[1] > 0
        mine = slice(rank * (D // world), (rank + 1) * (D // world))
        assert torch.equal(up, one[1][mine]), rank
        assert torch.equal(down, one[2][mine]), rank
    # the last shard's up and the first's down halo come from no shard
    assert float(one[1][0].abs().max()) == float(one[2][-1].abs().max()) == 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_split_levels_vcycle_and_cg_pass_match_one_process(world,
                                                           tmp_path):
    launched = _launched(tmp_path)
    ref = launched["one"]["pass-D4"]["first_pass"]
    assert (ref["n_split"], ref["n_levels"]) == (3, 4)
    covered = 0
    for rank, (_, runs) in enumerate(launched["ranked"][world]):
        got = runs["pass-D4"]["first_pass"]
        a, b = got["rows"]
        covered += b - a
        assert (got["n_split"], got["its"], got["rr"]) == (
            3, ref["its"], ref["rr"]), rank
        for key in ("R0", "Z", "X"):
            assert torch.equal(got[key], ref[key][:, a:b]), (key, rank)
    assert covered == ref["R0"].shape[1] == 81


def _jax_table(name):
    with open(os.path.join(REF, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("world,name", [(W, n) for W, (_, names)
                                        in sorted(WORLDS.items())
                                        for n in names if RUNS[n][1]])
def test_lattice_runs_on_ranks_match_one_process_and_jax(world, name,
                                                         tmp_path):
    launched = _launched(tmp_path)
    one = launched["one"][name]
    D = RUNS[name][0]["n_devices"]
    assert one["lattice"] and one["n_local"] == D and not one["cuts"]
    outs = launched["ranked"][world]
    for rank, (_, runs) in enumerate(outs):
        run = runs[name]
        assert run["lattice"] and run["n_local"] == D // world
        assert run["n_split"] == one["n_split"]
        assert run["stats"] == one["stats"], rank
        assert run["effort"] == one["effort"], rank
    jax = _jax_table(RUNS[name][1])
    assert set(jax["statistics"]) == set(one["stats"])
    for col in (c for c in COLS if c in one["stats"]):
        a = np.array([v for v in one["stats"][col] if v != ""], dtype=float)
        b = np.array([v for v in jax["statistics"][col] if v != ""],
                     dtype=float)
        assert a.shape == b.shape, col
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, err_msg=col)
    assert ([e[1] for e in one["effort"]]
            == [e["newton"] for e in jax["effort"]])
