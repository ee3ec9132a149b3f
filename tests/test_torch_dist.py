"""The halo pool on W processes (cracks_tpu_torch/parallel/dist.py): W
spawned ranks on the CPU, gloo, one torch thread each.

- `psum_shards` / `pmax_shards` / `gather_shards` on W = 2 and 4 ranks
  (D = 4 and 8, inside the launches of the dryrun cases below) equal
  the one-process collectives bit for bit on seeded (D, 37) f64
  inputs;
- the mesh of ``__graft_entry__.dryrun_multichip``'s halo step
  (sneddon_2d_1, 453 DoFs, two load steps, the Jacobi CG) at D = 4 on
  W = 2 and 4 ranks and at D = 8 on W = 4, and hetero_3d_1 (5,288 DoFs,
  two load steps) under tests/test_halo_newton.py's BASE at D = 4 on
  W = 2: every rank's statistics equal the one-process D-shard run's bit
  for bit, with equal Newton and linear iterations, and they equal the
  JAX package's n_devices = D halo run (tests/torch_reference/
  sneddon_2d_1_halo{4,8}.*, hetero_3d_1_halo4.*;
  `scripts/torch_reference.py` writes them) within
  tests/test_halo_newton.py's tolerance (abs 1e-6 or rel 1e-7), with
  equal Newton iterations and the two blocks' linear total within 2 per
  Newton iteration;
- the CLI under torchrun (2 ranks, D = 4): rank 0 alone writes the
  output, and its statistics file is the one-process run's;
- a world size W that does not divide n_devices raises ValueError
  (the lattice layout on W ranks: tests/test_torch_dist_lattice.py,
  its seam lattice tests/test_torch_dist_seam.py, the replicated
  cell-axis mode tests/test_torch_dist_replicated.py);
- a rank that raises ends the launch with `RankFailed` and its error
  within 30 s, long before the launch's deadline of 60 s (each spawned
  rank imports this module, JAX with it, which takes seconds); a rank
  that hangs ends it at a deadline of 5 s; the other ranks killed.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cracks_tpu_torch import config
from cracks_tpu_torch.driver import Simulation, run_prm
from cracks_tpu_torch.parallel import dist, sharding

from tests.regression import PRM_DIR, parse_statistics

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "tests", "torch_reference")
SNEDDON_1 = os.path.join(PRM_DIR, "sneddon_2d_1.prm")
HETERO = os.path.join(PRM_DIR, "hetero_3d_1.prm")
# the dryrun's halo step (tests/test_torch_halo_newton.py::DRYRUN)
DRYRUN = dict(n_local_pre_refine=1, value_phase_field_for_refinement=0.5,
              n_refinement_cycles=0, max_no_timesteps=1, linear_solver="cg",
              preconditioner="jacobi", output_dir="")
# tests/test_halo_newton.py's BASE (:28-29), two load steps
BASE = dict(output_dir="", direct_solver=False, linear_solver="cg",
            preconditioner="gmg", cg_rtol=1e-10, mixed_precision_cg=True,
            max_no_timesteps=1)
COLS = ("Bulk Energy", "Crack Energy")
CASES = {
    "dryrun-D4-W2": (SNEDDON_1, DRYRUN, 4, 2, "sneddon_2d_1_halo4"),
    "dryrun-D4-W4": (SNEDDON_1, DRYRUN, 4, 4, "sneddon_2d_1_halo4"),
    "dryrun-D8-W4": (SNEDDON_1, DRYRUN, 8, 4, "sneddon_2d_1_halo8"),
    "hetero-D4-W2": (HETERO, BASE, 4, 2, "hetero_3d_1_halo4"),
}


# ---------------------------------------------------------------------------
# what the ranks run (module level, so that spawned ranks import it)
# ---------------------------------------------------------------------------

def _seeded(D):
    return torch.as_tensor(np.random.default_rng(3).standard_normal((D, 37)))


def _collectives(ranks, D):
    """psum, pmax and gather of the rank's rows of a seeded (D, 37) f64
    tensor, and the collectives and bytes they counted."""
    dist.reset_counts()
    mesh = sharding.make_shard_mesh(["cpu"] * D, ranks=ranks)
    mine = _seeded(D)[mesh.first:mesh.first + mesh.n_local]
    return (sharding.psum_shards(mine, mesh).clone(),
            sharding.pmax_shards(mine, mesh).clone(),
            sharding.gather_shards(mine, mesh).clone(),
            dict(dist.COUNTS))


def _run(ranks, prm, over):
    sim = Simulation(config.load_parameters(prm, **over), device="cpu",
                     verbose=False)
    sim.run()
    part = sim.sys.halo_partition
    return dict(stats=sim.statistics.data, effort=sim.solver_effort,
                cuts=sim.step_cuts, halo=sim.sys.use_halo_state,
                n_local=None if part is None else part.n_local,
                loc_rows=None if part is None
                else int(part.arrays.loc2glob.shape[0]))


def _rank_case(ranks, prm, over):
    """A rank of one CASES entry: the collectives on its D shards, then
    the run."""
    return _collectives(ranks, over["n_devices"]), _run(ranks, prm, over)


def _raise_on_rank_1(ranks):
    if ranks.rank == 1:
        raise ValueError("rank 1 gives up")
    # rank 0 waits in a collective that rank 1 never joins
    sharding.psum_shards(torch.ones(1, 1), sharding.make_shard_mesh(
        ["cpu"] * ranks.world, ranks=ranks))
    return "unreachable"


def _hang_on_rank_1(ranks):
    if ranks.rank == 1:
        time.sleep(3600)
    return ranks.rank


# ---------------------------------------------------------------------------

def _reference(name):
    with open(os.path.join(REF, f"{name}.statistics")) as f:
        names, rows = parse_statistics(f.read())
    with open(os.path.join(REF, f"{name}.effort.json")) as f:
        effort = json.load(f)
    return ({c: np.array([r[names.index(c)] for r in rows], dtype=float)
             for c in COLS}, effort)


_LAUNCHED = {}


def _launched(case, tmp_path):
    """The one-process D-shard run of a case and its W ranks' results,
    run side by side, once per module."""
    if case not in _LAUNCHED:
        prm, base, D, W, _ = CASES[case]
        over = dict(base, n_devices=D, dof_sharding="lattice")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranked = pool.submit(dist.launch, _rank_case, W,
                                 args=(prm, over), device="cpu",
                                 rendezvous_dir=str(tmp_path),
                                 deadline_s=300)
            one = _run(None, prm, over)
            _LAUNCHED[case] = one, ranked.result()
    return _LAUNCHED[case]


@pytest.mark.parametrize("world,case", [(2, "dryrun-D4-W2"),
                                        (4, "dryrun-D8-W4")],
                         ids=["2", "4"])
def test_collectives_match_one_process(world, case, tmp_path):
    _, outs = _launched(case, tmp_path)
    D = CASES[case][2]
    x = _seeded(D)
    want_sum = sharding.psum_shards(x)[0]
    want_max = sharding.pmax_shards(x)[0]
    assert len(outs) == world
    for rank, ((s, m, g, counts), _) in enumerate(outs):
        assert s.shape == m.shape == (D // world, 37)
        assert torch.equal(s, want_sum.expand(s.shape)), rank
        assert torch.equal(m, want_max.expand(m.shape)), rank
        assert torch.equal(g, x), rank
        # two gathers of the rank's rows, one all-reduce of one row
        assert counts == dict(collectives=3,
                              bytes=(2 * (D // world) + 1) * 37 * 8)


@pytest.mark.parametrize("case", list(CASES))
def test_halo_pool_on_ranks(case, tmp_path):
    D, W, ref = CASES[case][2:]
    one, outs = _launched(case, tmp_path)
    assert one["halo"] and one["n_local"] == D and not one["cuts"]
    assert len(outs) == W
    for rank, (_, out) in enumerate(outs):
        # each rank holds its D / W shards of the pool
        assert out["halo"] and out["n_local"] == out["loc_rows"] == D // W
        assert out["stats"] == one["stats"], rank
        assert out["effort"] == one["effort"], rank
    jax_cols, jax_effort = _reference(ref)
    for col in COLS:
        a = jax_cols[col]
        d = np.abs(np.array(one["stats"][col], dtype=float) - a)
        assert ((d <= 1e-6) | (d <= 1e-7 * np.abs(a))).all(), (col, d)
    newton = [e[1] for e in one["effort"]]
    assert newton == [e["newton"] for e in jax_effort]
    lin = np.array([e[2] for e in one["effort"]])
    lin_j = np.array([e["linear"] for e in jax_effort])
    assert (np.abs(lin - lin_j) <= 2 * np.array(newton)).all(), (lin, lin_j)


def test_torchrun_cli_rank_zero_writes(tmp_path):
    """`torchrun -m cracks_tpu_torch` on 2 ranks at D = 4: rank 0 alone
    writes (its files are the one-process run's, its statistics equal),
    and the log names the transport."""
    keys = dict(DRYRUN, n_devices=4, dof_sharding="lattice")
    args = [f"{k}={v}" for k, v in keys.items() if k != "output_dir"]
    ranked, single = tmp_path / "ranks", tmp_path / "one"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "cracks_tpu_torch", SNEDDON_1,
         *args, "device=cpu", f"output_dir={ranked}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        run_prm(SNEDDON_1, device="cpu", **dict(keys,
                                                 output_dir=str(single)))
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    assert "2 ranks over gloo" in out
    assert out.count("Problem dimension") == 1
    assert sorted(os.listdir(ranked)) == sorted(os.listdir(single))
    with open(ranked / "statistics") as f, open(single / "statistics") as g:
        assert f.read() == g.read()


def test_world_size_must_divide_n_devices():
    """Refused before any collective, so a rank of a two-rank group
    that was never set up shows the refusal."""
    ranks = dist.Ranks(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divide"):
        Simulation(config.load_parameters(SNEDDON_1, **dict(
            DRYRUN, n_devices=3, dof_sharding="lattice")), device="cpu",
            verbose=False, ranks=ranks)


@pytest.mark.parametrize("fn,what,deadline",
                         [(_raise_on_rank_1, "rank 1 gives up", 60),
                          (_hang_on_rank_1, "deadline", 5)],
                         ids=["raises", "hangs"])
def test_failed_rank_ends_the_launch(fn, what, deadline, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(dist.RankFailed, match=what):
        dist.launch(fn, 2, device="cpu", rendezvous_dir=str(tmp_path),
                    timeout_s=60, deadline_s=deadline)
    assert time.monotonic() - t0 < 30
