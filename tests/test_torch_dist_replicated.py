"""The replicated cell-axis mode on W processes (ROADMAP A11e): the JAX
package's default distributed mode (``n_devices = D``, replicated DoF
vectors), W spawned gloo ranks on the CPU, one torch thread each, one
launch per W that runs all its cases; each is held bit for bit to the
same case in one process at the same n_devices, run meanwhile
(`parallel/sharding.py::CellRange`, `ops/scatter.py::CellScatter.
all_cells`).

(a) host only: the cell ranges of a 7 x 5 mesh (35 cells) at D = 1, 2,
    4 and 8 shards, every rank of W = 1, 2 and D: one contiguous range
    of (D / W) * ceil(35 / D) cells each, whose pieces laid end to end
    are the JAX package's ``pad_cell_arrays`` (the pad cells with zero
    JxW);
(b) on seeded inputs at D = 4 on W = 2 and W = 4, on the meshes of
    sneddon_2d_1 (one local pre-refinement, hanging nodes, with the
    stress split) and hetero_3d_1 (global 3 + local 1, hanging nodes):
    the residual, the jvp, the exact and the analytic Jacobi diagonals,
    the stored element matrices' u, phi and pu products and diagonals,
    and the dense reduced matrix of the direct solve: every rank's
    vectors equal the one-process functions' bit for bit, and every
    call of the element kernel on a rank takes that rank's range of
    cells only; and the card's pieces (`scatter.in_pieces`, here forced
    on the CPU, whose bits they keep) on the sneddon_2d_1 mesh: each
    range of D = 4 ranks, in the mesh's pieces that hold its cells (some
    ranges straddle two), or in one piece of all the cells, each cell at
    its place, gives the whole mesh's per-cell terms at once bit for
    bit;
(c) driver runs at n_devices = D on W ranks: sneddon_2d_1 as shipped
    (the dense direct solve, two mesh epochs) at D = W = 2; bench.py's
    Sneddon 2d settings at refine 3 (19,683 DoFs, two load steps, the
    lattice GMG mixed-precision CG; the solve split by row slab, three
    of its four levels) at D = W = 4; miehe_shear_1 under the simple
    monolithic solver on the matrix-free Jacobi CG (assembled_matvec =
    False), load step 0, at D = W = 2; threepoint_1's first four load
    steps at D = W = 2; hetero_3d_1 under the Galerkin GMG's
    mixed-precision split solve, load step 0, at D = W = 4 (the fine
    level split, the coarse chain built on every rank).  Every
    rank's statistics and Newton and linear iterations equal the
    one-process run's at the same D, whose statistics (but the Galerkin
    run's: tests/test_torch_hetero_mixed.py holds it against JAX at
    D = 1, which it equals) are within rel 1e-8 of the JAX package's
    run on D virtual devices with equal Newton and linear iterations
    (the lattice run's Newton iterations only: its f32 CG sums in
    another order, one iteration apart at load step 1;
    tests/torch_reference/replicated_np*.json, written by
    scripts/torch_reference.py so that no rank imports JAX); the
    golden runs also match tests/golden/sneddon_2d_1.statistics (the
    numdiff tolerance) and the first four rows of
    tests/golden/threepoint_1.mpirun=2.statistics (rel 1e-3, as
    tests/test_torch_cases_threepoint.py holds them).

Alone on one worker this file takes about 60 s on an 8-core CPU: the
two launches and the one-process runs side by side take about 50 s
each (the W = 2 launch's monolithic jvps and the W = 4 launch's
refine-3 lattice and Galerkin runs are the longest parts).  The module
imports JAX only in (a): the spawned ranks import it to unpickle what
they run.
"""

import concurrent.futures
import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from cracks_tpu_torch import config, meshio
from cracks_tpu_torch import mesh as hmesh
from cracks_tpu_torch.driver import Simulation, SolutionState
from cracks_tpu_torch.ops import physics, scatter
from cracks_tpu_torch.ops.scatter import CellScatter
from cracks_tpu_torch.parallel import dist, sharding
from cracks_tpu_torch.solvers import assembled, linear

from tests.regression import compare_statistics, load_golden, parse_statistics

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(REPO, "params")
REF = os.path.join(REPO, "tests", "torch_reference")
SNEDDON_1 = os.path.join(PRM, "tests", "sneddon_2d_1.prm")
HETERO = os.path.join(PRM, "tests", "hetero_3d_1.prm")
# scripts/torch_reference.py's BENCH3 (tests/test_torch_driver.py's
# BENCH): bench.py's Sneddon settings at refine 3, two load steps
BENCH3 = dict(n_global_pre_refine=3, n_local_pre_refine=0,
              n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
              linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
              cg_maxiter=3000, dtype="float64", mixed_precision_cg=True)
# (c): name -> (.prm, overrides with n_devices, the JAX table)
RUNS = {
    "sneddon_2d_1": (SNEDDON_1, dict(output_dir="", n_devices=2),
                     "replicated_np2_sneddon_2d_1"),
    "lattice_r3": (os.path.join(PRM, "parameters_sneddon_2d.prm"),
                   dict(BENCH3, n_devices=4), "replicated_np4_sneddon_2d_r3"),
    "monolithic": (os.path.join(PRM, "tests", "miehe_shear_1.prm"),
                   dict(output_dir="", max_no_timesteps=0,
                        outer_solver="simple monolithic", linear_solver="cg",
                        assembled_matvec=False, n_devices=2),
                   "replicated_np2_miehe_shear_1_monolithic"),
    "threepoint": (os.path.join(PRM, "tests", "threepoint_1.prm"),
                   dict(output_dir="", max_no_timesteps=3, n_devices=2),
                   "replicated_np2_threepoint_1"),
    # the Galerkin GMG's split solve (one process: tests/
    # test_torch_hetero_mixed.py against JAX)
    "galerkin": (HETERO, dict(output_dir="", max_no_timesteps=0,
                              linear_solver="cg", preconditioner="gmg",
                              mixed_precision_cg=True, n_devices=4), None),
}
# (b): the meshes, whose pre-refinement each System repeats
MESHES = {"sneddon_2d_1": (SNEDDON_1, dict(linear_solver="direct")),
          "hetero_3d_1": (HETERO, dict(linear_solver="direct",
                                       preconditioner="jacobi"))}
D_SEEDED = 4
# world -> its driver runs (each at D = W)
WORLDS = {2: ["sneddon_2d_1", "monolithic", "threepoint"],
          4: ["lattice_r3", "galerkin"]}
FUNCTIONS = ("residual", "jvp", "diagonal", "jacobi", "uu", "pp", "pu",
             "diagonals", "dense")


# ---------------------------------------------------------------------------
# (a) the cell ranges
# ---------------------------------------------------------------------------

def _mesh_35():
    forest = hmesh.Forest(meshio.rect_mesh([0.0, 0.0], [7.0, 5.0], [7, 5]))
    return forest.extract()


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_cell_ranges_are_jax_padded_shards(D):
    import jax.numpy as jnp
    from cracks_tpu.ops import physics as jphysics
    from cracks_tpu.parallel.sharding import pad_cell_arrays

    mesh = _mesh_35()
    n_c = mesh.n_cells
    assert n_c == 35 and (D == 1 or n_c % D)
    lam = np.full(n_c, 2.0)
    mu = np.full(n_c, 3.0)
    ca = physics.cell_arrays_from_core(
        physics.build_cell_core(mesh, lam, mu, device="cpu"), torch.float64)
    jca = pad_cell_arrays(jphysics.cell_arrays_from_core(
        jphysics.build_cell_core(mesh, lam, mu), dtype=jnp.float64), D)
    m = -(-n_c // D)
    for W in sorted({1, 2, D} & set(range(1, D + 1))):
        if D % W:
            continue
        pieces = []
        for r in range(W):
            ranks = None if W == 1 else dist.Ranks(r, W, torch.device("cpu"),
                                                   "gloo")
            cells = sharding.CellRange(
                n_c, sharding.make_shard_mesh(["cpu"] * D, ranks=ranks))
            assert (cells.lo, cells.hi) == (r * (D // W) * m,
                                            (r + 1) * (D // W) * m)
            pieces.append(cells.own(ca))
        for name in ("gather_u", "gather_p", "JxW", "grads", "lam", "mu",
                     "inv_diam2"):
            got = torch.cat([getattr(p, name) for p in pieces], dim=-1)
            want = np.asarray(getattr(jca, name))
            assert got.shape == want.shape == (want.shape[:-1] + (D * m,))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        JxW = torch.cat([p.JxW for p in pieces], dim=-1)
        assert float(JxW[:, n_c:].abs().sum()) == 0.0
        assert float(JxW[:, :n_c].min()) > 0.0


# ---------------------------------------------------------------------------
# (b) the per-cell functions on seeded inputs
# ---------------------------------------------------------------------------

def _system(mesh_name):
    """The System of the mesh after the prm's pre-refinement, at
    n_devices = D_SEEDED (on this process's ranks, if any)."""
    prm, over = MESHES[mesh_name]
    sim = Simulation(config.load_parameters(prm, output_dir="",
                                            n_devices=D_SEEDED, **over),
                     device="cpu", verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    zu = torch.zeros(sim.mesh.n_vertices * sim.mesh.dim, dtype=torch.float64)
    zp = torch.zeros(sim.mesh.n_vertices, dtype=torch.float64)
    state = SolutionState(u=zu, phi=zp, u_old=zu, phi_old=zp, phi_oold=zp)
    for _ in range(sim.p.n_local_pre_refine):
        sim.interpolate_initial_values(state)
        state.u_old, state.phi_old, state.phi_oold = (state.u, state.phi,
                                                      state.phi)
        sim.refine_mesh(state)
    sim._set_context()
    return sim.sys


def _functions(mesh_name):
    """Each function of FUNCTIONS on inputs drawn from a seeded
    generator, and the cell counts of every element-kernel call."""
    sys_ = _system(mesh_name)
    dim, n_v = sys_.dim, sys_.mesh.n_vertices
    assert sys_.mesh.hanging_mask().any()
    rng = np.random.default_rng(11)
    draw = lambda n, lo, hi: torch.as_tensor(rng.uniform(lo, hi, n))
    u, du, xu, rhs_u = (draw(n_v * dim, -1e-2, 1e-2) for _ in range(4))
    phi, pfo, pfoo, dp, xp, rhs_p = (draw(n_v, 0.0, 1.0) for _ in range(6))
    active = torch.as_tensor(rng.uniform(size=n_v) > 0.8)
    ca, cs, sc = sys_.ca, sys_.cell_scatter, sys_.scalars
    kw = dict(dim=dim, with_split=dim == 2, monolithic=False)
    seen = []
    kernel = physics._element_residual_cl

    def counted(u_e, *args, **kwargs):
        seen.append(u_e.shape[-1])
        return kernel(u_e, *args, **kwargs)

    physics._element_residual_cl = counted
    try:
        out = dict(
            residual=physics.assemble_residual(u, phi, pfo, pfoo, ca, sc, cs,
                                               **kw),
            jvp=physics.jacobian_vector_product(u, phi, du, dp, pfo, pfoo,
                                                ca, sc, cs, **kw),
            diagonal=physics.jacobian_diagonal(u, phi, pfo, pfoo, ca, sc, cs,
                                               **kw),
            jacobi=physics.jacobi_diagonal_approx(u, phi, pfo, pfoo, ca, sc,
                                                  cs, dim=dim,
                                                  monolithic=False))
        jac = assembled.build_jacobians(u, phi, pfo, pfoo, ca, sc, **kw)
        out.update(
            uu=assembled.matvec_uu(jac, ca, xu, cs, dim=dim),
            pp=assembled.matvec_pp(jac, ca, xp, cs, dim=dim),
            pu=assembled.matvec_pu(jac, ca, xu, cs, dim=dim),
            diagonals=assembled.diagonals(jac, ca, cs, dim=dim),
            dense=linear._reduced_system(
                u, phi, pfo, pfoo, sys_.ca_all, sc, sys_.constraints(0.0),
                active, rhs_u, rhs_p, cs=sys_.cell_scatter, **kw)[0])
    finally:
        physics._element_residual_cl = kernel
    cells = sys_.cells
    return dict(out=out, seen=sorted(set(seen)), n_cells=sys_.mesh.n_cells,
                range=None if cells is None else (cells.lo, cells.hi))


class _Caught(Exception):
    pass


class _Tap(CellScatter):
    """A CellScatter of no tables, with the card's pieces and a range of
    cells: keeps the per-cell terms of its cells handed to the gather
    before the scatter and stops the function there."""

    def all_cells(self, *values, axis=-1):
        self.values = values
        raise _Caught


def _cell_terms(sys_, ca, inputs, piece, cells=None):
    """name -> the per-cell terms of ca's cells (`cells`, or all) that
    each function of FUNCTIONS (but the dense matrix) hands to the
    scatter, in pieces of `piece` cells."""
    u, du, xu, phi, pfo, pfoo, dp, xp = inputs
    sc, dim = sys_.scalars, sys_.dim
    kw = dict(dim=dim, with_split=dim == 2, monolithic=False)
    tap = lambda: _Tap(None, None, 0, 0, cells, piece)
    jac = assembled.build_jacobians(u, phi, pfo, pfoo, ca, sc, cs=tap(),
                                    **kw)
    calls = dict(
        residual=lambda cs: physics.assemble_residual(u, phi, pfo, pfoo, ca,
                                                      sc, cs, **kw),
        jvp=lambda cs: physics.jacobian_vector_product(
            u, phi, du, dp, pfo, pfoo, ca, sc, cs, **kw),
        diagonal=lambda cs: physics.jacobian_diagonal(u, phi, pfo, pfoo, ca,
                                                      sc, cs, **kw),
        jacobi=lambda cs: physics.jacobi_diagonal_approx(
            u, phi, pfo, pfoo, ca, sc, cs, dim=dim, monolithic=False),
        uu=lambda cs: assembled.matvec_uu(jac, ca, xu, cs, dim=dim),
        pp=lambda cs: assembled.matvec_pp(jac, ca, xp, cs, dim=dim),
        pu=lambda cs: assembled.matvec_pu(jac, ca, xu, cs, dim=dim))
    out = dict(matrices=(jac,))
    for name, call in calls.items():
        cs = tap()
        with pytest.raises(_Caught):
            call(cs)
        out[name] = cs.values
    return out


@pytest.mark.parametrize("first,n,size", [(0, 124, 124), (0, 124, 32),
                                          (31, 31, 32), (62, 62, 32),
                                          (93, 35, 32)])
def test_in_pieces_keeps_each_cell_at_its_place(first, n, size,
                                                monkeypatch):
    """`scatter.in_pieces` (forced on the CPU) on the cells [first,
    first + n) of a mesh: fn sees the mesh's pieces of `size` cells that
    hold them, each of those cells at its place in its piece, and the
    result is fn's of these cells in order."""
    monkeypatch.setattr(scatter, "PIECES_ON_CPU", True)
    ids = torch.arange(first, first + n)
    seen = []

    def fn(piece, twice):
        seen.append(piece)
        return piece * 3, twice + 1

    out = scatter.in_pieces(fn, size, first, ids, 2 * ids[None, :])
    assert torch.equal(out[0], 3 * ids) and torch.equal(out[1][0],
                                                        2 * ids + 1)
    if first == 0 and n == size:
        assert len(seen) == 1 and torch.equal(seen[0], ids)
        return
    ks = range(first // size, -(-(first + n) // size))
    assert len(seen) == len(ks)
    for k, piece in zip(ks, seen):
        place = torch.arange(k * size, (k + 1) * size)
        held = (place >= first) & (place < first + n)
        assert piece.shape == (size,) and held.any()
        assert torch.equal(piece[held], place[held])
        assert set(piece[~held].tolist()) <= {first, first + n - 1}


@pytest.mark.parametrize("piece_min", [64, 1 << 20], ids=["pieces", "whole"])
def test_card_pieces_keep_a_cells_bits(piece_min, monkeypatch):
    """The card's pieces (`scatter.in_pieces`, here on the CPU, whose
    bits they keep): at most five of at least 64 cells, which the
    ranges of D = 4 ranks straddle, or (a mesh of at most PIECE_MIN
    cells) one piece of all the cells; a range computes the pieces that
    hold its cells, each cell at its place in them, the other places
    filled: each range gives the per-cell terms of the whole mesh at
    once bit for bit, from pieces of `piece` cells only."""
    monkeypatch.setattr(scatter, "PIECE_MIN", piece_min)
    monkeypatch.setattr(scatter, "CELL_PIECES", 5)
    sys_ = _system("sneddon_2d_1")
    monkeypatch.setattr(scatter, "PIECES_ON_CPU", True)
    n_v, dim, n_c = sys_.mesh.n_vertices, sys_.dim, sys_.mesh.n_cells
    rng = np.random.default_rng(3)
    draw = lambda n, lo, hi: torch.as_tensor(rng.uniform(lo, hi, n))
    inputs = (*(draw(n_v * dim, -1e-2, 1e-2) for _ in range(3)),
              *(draw(n_v, 0.0, 1.0) for _ in range(5)))
    whole = _cell_terms(sys_, sys_.ca, inputs, 0)
    piece = sys_.cell_scatter.piece
    assert piece == scatter.piece_size(n_c, D_SEEDED) == (
        n_c if n_c <= piece_min else max(-(-n_c // 5), 64))
    straddles = 0
    for r in range(D_SEEDED):
        ranks = dist.Ranks(r, D_SEEDED, torch.device("cpu"), "gloo")
        cells = sharding.CellRange(n_c, sharding.make_shard_mesh(
            ["cpu"] * D_SEEDED, ranks=ranks))
        straddles += cells.lo // piece != (cells.hi - 1) // piece
        seen = []
        kernel = physics._element_residual_cl

        def counted(u_e, *args, **kwargs):
            seen.append(u_e.shape[-1])
            return kernel(u_e, *args, **kwargs)

        monkeypatch.setattr(physics, "_element_residual_cl", counted)
        got = _cell_terms(sys_, cells.own(sys_.ca), inputs, piece, cells)
        monkeypatch.setattr(physics, "_element_residual_cl", kernel)
        assert set(seen) == {piece}, r
        hi = min(cells.hi, n_c)
        for name, values in got.items():
            for a, b in zip(values, whole[name]):
                assert a.shape[-1] == cells.hi - cells.lo, name
                assert torch.equal(a[..., :hi - cells.lo],
                                   b[..., cells.lo:hi]), (name, r)
    assert (straddles > 0) == (piece < n_c)


# ---------------------------------------------------------------------------
# (c) the driver
# ---------------------------------------------------------------------------

def _run(name):
    prm, over, _ = RUNS[name]
    sim = Simulation(config.load_parameters(prm, **over), device="cpu",
                     verbose=False)
    sim.run()
    return dict(stats=sim.statistics.data, effort=sim.solver_effort,
                text=sim.statistics.write_text(), cuts=sim.step_cuts,
                cells=sim.sys.cells is not None,
                n_split=(None if sim.sys.lattice_hierarchy is None
                         else sim.sys.lattice_hierarchy.n_split))


def _rank(ranks, names):
    return ({m: _functions(m) for m in MESHES},
            {n: _run(n) for n in names})


def _one_process():
    return ({m: _functions(m) for m in MESHES},
            {n: _run(n) for n in RUNS})


_LAUNCHED = {}


def _launched(tmp_path):
    """Both worlds' launches and the one-process runs in a spawned
    worker, side by side, once per module."""
    if not _LAUNCHED:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool, \
                concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=ctx) as worker:
            one = worker.submit(_one_process)
            ranked = {W: pool.submit(dist.launch, _rank, W, args=(names,),
                                     device="cpu",
                                     rendezvous_dir=str(tmp_path),
                                     deadline_s=400)
                      for W, names in WORLDS.items()}
            _LAUNCHED.update(one=one.result(),
                             ranked={W: f.result()
                                     for W, f in ranked.items()})
    return _LAUNCHED


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cell_functions_on_ranks_match_one_process(world, mesh_name,
                                                   tmp_path):
    launched = _launched(tmp_path)
    one = launched["one"][0][mesh_name]
    n_c = one["n_cells"]
    assert one["range"] is None and one["seen"] == [n_c]
    m = -(-n_c // D_SEEDED) * (D_SEEDED // world)
    covered = []
    for rank, (functions, _) in enumerate(launched["ranked"][world]):
        got = functions[mesh_name]
        # the rank's element kernel takes its cells, no other
        assert got["range"] == (rank * m, (rank + 1) * m), rank
        assert got["seen"] == [m] and m < n_c, rank
        covered.append(got["range"])
        for name in FUNCTIONS:
            want, have = one["out"][name], got["out"][name]
            for a, b in zip(want if isinstance(want, tuple) else (want,),
                            have if isinstance(have, tuple) else (have,)):
                assert torch.equal(a, b), (name, rank)
    assert covered[0][0] == 0 and covered[-1][1] >= n_c


def _jax_table(name):
    with open(os.path.join(REF, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("world,name", [(W, n) for W, names
                                        in sorted(WORLDS.items())
                                        for n in names])
def test_replicated_runs_on_ranks_match_one_process_and_jax(world, name,
                                                            tmp_path):
    launched = _launched(tmp_path)
    one = launched["one"][1][name]
    assert not one["cells"] and not one["cuts"]
    for rank, (_, runs) in enumerate(launched["ranked"][world]):
        run = runs[name]
        assert run["cells"], rank
        assert run["stats"] == one["stats"], rank
        assert run["effort"] == one["effort"], rank
    if name == "lattice_r3":
        # three of the four levels split by slab on the ranks
        assert one["n_split"] == 0 and run["n_split"] == 3
    if RUNS[name][2] is None:
        return
    jax = _jax_table(RUNS[name][2])
    assert jax["statistics"]["DoFs"] == one["stats"]["DoFs"]
    for col in ("Bulk Energy", "Crack Energy", "TCV", "Load x", "Load P11"):
        if col not in one["stats"]:
            continue
        a = np.array([v for v in one["stats"][col] if v != ""], dtype=float)
        b = np.array([v for v in jax["statistics"][col] if v != ""],
                     dtype=float)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, err_msg=col)
    # the lattice's f32 CG sums in another order than JAX's (one
    # iteration apart at load step 1, as tests/test_torch_driver.py
    # finds): its Newton iterations only
    k = 2 if name == "lattice_r3" else 3
    assert ([list(e[1:k]) for e in one["effort"]]
            == [[e["newton"], e["linear"]][:k - 1] for e in jax["effort"]])
    if name == "sneddon_2d_1":
        compare_statistics(one["text"], "sneddon_2d_1.statistics")
    if name == "threepoint":
        ours = parse_statistics(one["text"])[1][:4]
        golden = load_golden("threepoint_1.mpirun=2.statistics")[1][:4]
        diff = np.abs(ours - golden)
        ok = (diff <= 1e-6) | (diff <= 1e-3 * np.abs(golden))
        assert ours.shape == golden.shape and ok.all()
