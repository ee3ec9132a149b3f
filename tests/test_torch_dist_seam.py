"""The seam lattice on W processes (ROADMAP A11d, part 2): the slit mesh
of the Miehe cases under the lattice layout, W spawned gloo ranks on the
CPU, one torch thread each, one launch per W that runs all its cases;
each is held bit for bit to the same case in one process, run meanwhile
(`solvers/lattice.py`: `seam_ext`, `seam_collect_rows`, the slab
transfers and coarsening with a seam; `parallel/sharding.py::
level_bounds`).

(a) host only: the seam-aware row slabs of every level of the slit
    lattice at refine 3-8 on D = 1, 2, 4 and 8 shards: every coarse row
    lies on the shard of its fine parent (row 2c, or 2c - 1 on the upper
    lip), and the lip rows s_c and s_c + 1 share a shard exactly when s
    and s + 1 do; at D = 2 the seam straddles the shard boundary on
    every level;
(b) on seeded canonical vectors at refine 4 (the (34, 33) lattice, slit
    row 16, 3 levels): the spread onto the halo'd rows, the collect, the
    masked product on halo'd rows and the sharded product, the
    restriction, the prolongation (from the coarse slab and from the
    whole coarse level), the active-set injection and the Galerkin
    coarsening, at D = 2 on W = 2 (the seam on the rank boundary of the
    two split levels: the collect's one exchange between those two
    ranks) and D = 4 on W = 4: each rank's rows equal the one-process
    functions' rows;
(c) params/tests/miehe_shear_2.prm at refine 4 (3,315 DoFs), three load
    steps under tests/test_torch_cases_seam.py's settings, at D = 2 on
    W = 2 and D = 4 on W = 4, two of the three GMG levels split by slab:
    every rank's statistics and Newton and linear iterations equal the
    one-process run's at the same D.  As that run, load step 0 is within
    rel 1e-8 of the JAX package's lattice-layout run on 4 virtual
    devices with equal Newton iterations
    (tests/torch_reference/miehe_shear_2_lattice_np4.json, written by
    scripts/torch_reference.py so that no rank imports JAX).  From load
    step 1 the two part at a line search at the rounding floor (ROADMAP
    C11): the port's per-row dot sums take the step's third Newton
    iteration's full step (residual 3.97e-10 from 4.02e-10), JAX's
    global sums reject it (2.8e-4), and the active sets settle apart
    (20 and 51 dofs, crack energy 0.6 % apart; load step 2 3e-5).

Alone on one worker this file takes about 30 s on an 8-core CPU, most
of it the four driver runs side by side (each 7-10 s on one thread).
The module imports no JAX: the spawned ranks import it to unpickle what
they run.
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
from cracks_tpu_torch.solvers.galerkin import embedding_matrices

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(REPO, "params", "tests", "miehe_shear_2.prm")
REF = os.path.join(REPO, "tests", "torch_reference",
                   "miehe_shear_2_lattice_np4.json")
# tests/test_torch_cases_seam.py's MIEHE at refine 4
MIEHE = dict(max_no_timesteps=2, output_dir="", linear_solver="cg",
             direct_solver=False, preconditioner="gmg",
             mixed_precision_cg=True, cg_rtol=1e-8, n_global_pre_refine=4,
             dof_sharding="lattice")
# the refine-4 slit lattice: grid, seam, levels
GRID, SEAM, LEVELS = (34, 33), lattice.Seam(16, 17), 3
WORLDS = (2, 4)          # each at D = W
# the load steps held to the JAX table (see (c))
JAX_STEPS = 1
COLS = ("Bulk Energy", "Crack Energy", "Load x")


# ---------------------------------------------------------------------------
# (a) the seam-aware row slabs
# ---------------------------------------------------------------------------

def _slit_levels(refine):
    """(rows, seam row, levels) of the slit lattice at a refinement, as
    `lattice.build_lattice_hierarchy` coarsens it."""
    grid = (2 ** (refine + 1) + 2, 2 ** (refine + 1) + 1)
    seam = lattice.Seam(2 ** refine, 2 ** refine + 1)
    grids, seams = [grid], [seam]
    while lattice._seam_can_coarsen(grids[-1], seams[-1]):
        g_c = lattice._seam_coarse_grid(grids[-1], seams[-1])
        if np.prod(g_c) < 50:
            break
        grids.append(g_c)
        seams.append(lattice.seam_coarse(seams[-1]))
    return grids, seams


def _owner(bounds, row):
    return next(i for i in range(len(bounds) - 1)
                if bounds[i] <= row < bounds[i + 1])


@pytest.mark.parametrize("refine", range(3, 9))
def test_seam_level_slabs(refine):
    grids, seams = _slit_levels(refine)
    for D in (1, 2, 4, 8):
        mesh = sharding.ShardMesh(D, torch.device("cpu"))
        rows, bounds = sharding.level_bounds(mesh, grids[0][0], len(grids),
                                             seams[0].s)
        assert rows == [g[0] for g in grids]
        for l in range(len(grids)):
            assert bounds[l][0] == 0 and bounds[l][-1] == rows[l]
            s = seams[l].s
            straddles = _owner(bounds[l], s) != _owner(bounds[l], s + 1)
            if l == 0:
                fine_straddles = straddles
                assert straddles == (D == 2 or (D == 8 and refine == 3)), D
            else:
                assert straddles == fine_straddles, (refine, D, l)
                sf = seams[l - 1].s
                for c in range(rows[l]):
                    parent = 2 * c if c <= sf // 2 else 2 * c - 1
                    assert (_owner(bounds[l], c)
                            == _owner(bounds[l - 1], parent)), (D, l, c)
        slabs, n_split = sharding.level_slabs(mesh, grids[0][0], len(grids),
                                              seams[0].s)
        assert [sl.g for sl in slabs] == rows
        assert all((sl.a, sl.b) == (0, sl.g) for sl in slabs)
        assert 1 <= n_split <= len(grids) - 1


# ---------------------------------------------------------------------------
# (b) the seam's functions on a process's rows
# ---------------------------------------------------------------------------

def _inputs():
    """Seeded f64 inputs on the refine-4 lattice: element matrices with
    the dead cell row zero, a free mask with the mirror slots pinned,
    canonical fine and coarse vectors, a consistent one, an active
    mask."""
    rng = np.random.default_rng(16)
    gy, gx = GRID
    s, lo = SEAM
    gc = lattice._seam_coarse_grid(GRID, SEAM)
    sc = lattice.seam_coarse(SEAM)
    jac = rng.standard_normal((12, 12, gy - 1, gx - 1))
    jac[:, :, s] = 0.0
    free = rng.uniform(size=(2, gy, gx)) > 0.1
    free[:, s + 1, :lo] = False
    X = rng.standard_normal((2, gy, gx))
    X[:, s + 1, :lo] = 0.0
    Y = rng.standard_normal((2, gy, gx))
    Xc = rng.standard_normal((2,) + gc)
    Xc[:, sc.s + 1, :sc.slit_lo] = 0.0
    act = rng.uniform(size=(1, gy, gx)) < 0.3
    return [torch.as_tensor(a) for a in (jac, free, X, Y, Xc, act)]


def _lops(jac, free):
    return lattice._LOps(jac=jac, free=free, Dinv=None, lam=None, rng=None)


def _functions(mesh):
    """Each function of (b) on this process's rows (`mesh` on W ranks,
    or one process of D shards), as a dict of tensors, with the seam's
    exchanges it made."""
    jac, free, X, Y, Xc, act = _inputs()
    slabs, n_split = sharding.level_slabs(mesh, GRID[0], LEVELS, SEAM.s)
    sl, slc, sl2 = slabs
    seams = lattice.seam_levels(SEAM, LEVELS)[::-1]     # finest first
    P_embed = torch.as_tensor(embedding_matrices(2))
    c0, c1 = sl.cells
    held = jac[:, :, c0:c1].contiguous()
    lv = _lops(held, sl.rows(free))
    X_own = sl.rows(X).contiguous()
    dist.reset_counts()
    out = dict(n_split=n_split, rows=[(s.a, s.b) for s in slabs])
    out["spread"] = lattice.seam_ext(sl, SEAM, X_own)[0]
    out["collect"] = lattice.seam_collect(sl.rows(Y), SEAM, sl)
    out["product"] = lattice._masked_mv(lv, 0, 8, 2, SEAM, sl)(X_own)
    f32 = lambda t: t.to(torch.float32).contiguous()
    pad = stencil.pad_jac_sharded(lattice._owned_cells(f32(held), sl), 0, 8,
                                  0, 8, mesh, rows_loc=mesh.rows_loc(GRID[0]))
    out["sharded"] = lattice._sharded_op(_lops(None, lv.free), pad, 2, mesh,
                                         SEAM, sl)(f32(X_own))
    out["restrict"] = lattice.restrict_slab(X_own, sl, slc, SEAM)
    out["restrict2"] = lattice.restrict_slab(slc.rows(Xc), slc, sl2,
                                             seams[1])
    out["prolong"] = lattice.prolong_slab(slc.rows(Xc), sl, slc, False,
                                          SEAM)
    out["prolong_whole"] = lattice.prolong_slab(Xc, sl, slc, True, SEAM)
    out["inject"] = lattice.inject_slab(sl.rows(act), sl, slc, SEAM)
    out["coarsen"] = lattice.coarsen_slab(held, P_embed, sl, slc, SEAM)
    out["seam_exchanges"] = dist.EXCHANGES["seam"]
    return out


def _whole_functions(D):
    """The same functions of the whole levels in one process: the
    global seam forms, and the one-process D-shard sharded product."""
    jac, free, X, Y, Xc, act = _inputs()
    sc = lattice.seam_coarse(SEAM)
    P_embed = torch.as_tensor(embedding_matrices(2))
    one = sharding.make_shard_mesh(["cpu"] * D)
    f32 = lambda t: t.to(torch.float32).contiguous()
    pad = stencil.pad_jac_sharded(f32(jac), 0, 8, 0, 8, one)
    return dict(
        spread=lattice.seam_spread(X, SEAM),
        collect=lattice.seam_collect(Y, SEAM),
        product=lattice._masked_mv(_lops(jac, free), 0, 8, 2, SEAM)(X),
        sharded=lattice._sharded_op(_lops(None, free), pad, 2, one,
                                    SEAM)(f32(X)),
        restrict=lattice.restrict_seam(X, 2, SEAM),
        restrict2=lattice.restrict_seam(Xc, 2, sc),
        prolong=lattice.prolong_seam(Xc, GRID, 2, SEAM),
        prolong_whole=lattice.prolong_seam(Xc, GRID, 2, SEAM),
        inject=lattice._seam_inject_down(act, SEAM),
        coarsen=lattice.coarsen_seam(jac, P_embed, SEAM))


def _rank(ranks):
    D = ranks.world
    mesh = sharding.make_shard_mesh(["cpu"] * D, ranks=ranks)
    return _functions(mesh), {D: _run(D)}


# ---------------------------------------------------------------------------
# (c) the driver
# ---------------------------------------------------------------------------

def _run(D):
    sim = Simulation(config.load_parameters(PRM, **MIEHE, n_devices=D),
                     device="cpu", verbose=False)
    sim.run()
    hier = sim.sys.lattice_hierarchy
    return dict(stats=sim.statistics.data, effort=sim.solver_effort,
                cuts=sim.step_cuts, lattice=sim.sys.use_lattice_state,
                seam=tuple(hier.seam), n_split=hier.n_split,
                n_levels=hier.n_levels,
                n_local=sim.sys.shard_mesh.n_local)


def _one_process(worlds):
    return {D: _run(D) for D in worlds}


_LAUNCHED = {}


def _launched(tmp_path):
    """Both worlds' launches and the one-process runs in a spawned
    worker, side by side, once per module."""
    if not _LAUNCHED:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool, \
                concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=ctx) as worker:
            one = worker.submit(_one_process, WORLDS)
            ranked = {W: pool.submit(dist.launch, _rank, W, device="cpu",
                                     rendezvous_dir=str(tmp_path),
                                     deadline_s=400)
                      for W in WORLDS}
            _LAUNCHED.update(one=one.result(),
                             ranked={W: f.result()
                                     for W, f in ranked.items()})
    return _LAUNCHED


@pytest.mark.parametrize("world", WORLDS)
def test_seam_functions_on_ranks_match_one_process(world, tmp_path):
    outs = _launched(tmp_path)["ranked"][world]
    ref = _whole_functions(world)
    covered = 0
    for rank, (got, _) in enumerate(outs):
        assert got["n_split"] == 2
        (a, b), (ca, cb), _ = got["rows"]
        covered += b - a
        fine = sharding.Slab(GRID[0], a, b)
        e0, e1 = fine.e0, fine.e1
        coarse = sharding.Slab(ref["restrict"].shape[1], ca, cb)
        q0, q1 = coarse.cells
        expect = dict(
            spread=ref["spread"][:, e0:e1], collect=ref["collect"][:, a:b],
            product=ref["product"][:, a:b], sharded=ref["sharded"][:, a:b],
            restrict=ref["restrict"][:, ca:cb],
            restrict2=ref["restrict2"][:, slice(*got["rows"][2])],
            prolong=ref["prolong"][:, a:b],
            prolong_whole=ref["prolong_whole"][:, a:b],
            inject=ref["inject"][:, ca:cb],
            coarsen=ref["coarsen"][:, :, q0:q1])
        for key, want in expect.items():
            assert torch.equal(got[key], want), (key, rank)
        # the collect's exchange runs between the two lip rows' owners
        # only, on the two split levels the seam straddles at D = 2
        # (the collect, the product's, the restriction's)
        straddles = world == 2
        assert (got["seam_exchanges"] > 0) == straddles, rank
    assert covered == GRID[0]
    # the mirror slots stay canonical
    s, lo = SEAM
    for key in ("collect", "product", "sharded", "prolong"):
        assert float(ref[key][:, s + 1, :lo].abs().max()) == 0.0, key


@pytest.mark.parametrize("world", WORLDS)
def test_seam_runs_on_ranks_match_one_process_and_jax(world, tmp_path):
    launched = _launched(tmp_path)
    one = launched["one"][world]
    assert one["lattice"] and one["seam"] == tuple(SEAM)
    assert (one["n_split"], one["n_levels"], one["n_local"]) == (2, 3, world)
    assert not one["cuts"]
    for rank, (_, runs) in enumerate(launched["ranked"][world]):
        run = runs[world]
        assert run["n_local"] == 1 and run["n_split"] == one["n_split"]
        assert run["stats"] == one["stats"], rank
        assert run["effort"] == one["effort"], rank
    with open(REF) as f:
        jax = json.load(f)
    assert len(jax["effort"]) == len(one["effort"]) == 3
    for col in COLS:
        a = np.array(one["stats"][col][:JAX_STEPS], dtype=float)
        b = np.array(jax["statistics"][col][:JAX_STEPS], dtype=float)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, err_msg=col)
    assert ([e[1] for e in one["effort"][:JAX_STEPS]]
            == [e["newton"] for e in jax["effort"][:JAX_STEPS]])
