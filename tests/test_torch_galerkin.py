"""The Galerkin GMG of the PyTorch port (cracks_tpu_torch/solvers/
galerkin.py) against the JAX package's (cracks_tpu/solvers/galerkin.py),
on the hetero_3d_1 mesh (3d, one local pre-refinement, 318 hanging
vertices) and 2d Sneddon meshes with one and two local
pre-refinements (with two, a coarse level has hanging nodes of its
own), in f64 on the CPU:

- the hierarchy: gathers, parent maps, position codes, prolongation
  stencils and each level's constraint bundle equal exactly;
- from the same element matrices (the JAX package's, at a seeded state
  with a seeded active set): the RAP chain, the smoother data and one
  V-cycle on a seeded vector within rel 1e-12 (f64), the f32 V-cycle
  within rtol 1e-5 / atol 1e-4 of its largest value, and the sharp
  (Lanczos) spectral estimates within rel 1e-5 (their tridiagonal
  eigenproblem is solved in f32 in both packages);
- `solve_cg_block` on the Newton system of a Sneddon 2d refine 3 run
  within rel 1e-9 of the JAX solve, with the same iteration count;
- `solve_split` through the whole hetero_3d_1 run with mixed precision,
  the port's fused-size threshold at 0, against the JAX split solve
  (``FUSED_SOLVE_MAX_DOFS = 0``; its level cache is off, as the port's
  is below the sharp-spectrum size; the port's default run against
  JAX's default fused one is tests/test_torch_hetero_mixed.py's): bulk
  and crack energy within rel 1e-6 and equal Newton counts per step.
  The linear counts differ by at most 2 iterations per Newton solve:
  a pass is 1-10 f32 iterations here, and the f32 element matrices of
  the two packages round differently (torch's f32 einsum of the
  gradient term rounds about twice JAX's on the CPU), so a pass may end
  an iteration later or earlier (ROADMAP C9);
- the multigrid helpers (`_prolong`, `_restrict`, `_chebyshev`,
  `lanczos_lambda_max`, `_power_lambda_max`) on a small system."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu import config as jconfig, problems as jproblems
from cracks_tpu.driver import System as JSystem, run_prm as jrun_prm
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.meshio import read_ucd as jread_ucd, rect_mesh as jrect_mesh
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.solvers import galerkin as jg, multigrid as jmg
from cracks_tpu_torch import config, interop
from cracks_tpu_torch.driver import Simulation, SolutionState, run_prm
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.solvers import galerkin, multigrid

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HETERO = os.path.join(ROOT, "params", "tests", "hetero_3d_1.prm")
SNEDDON = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
MESHES = {
    "hetero_3d_1": (HETERO, dict(linear_solver="cg", preconditioner="gmg")),
    "sneddon_2d_local": (SNEDDON, dict(
        n_global_pre_refine=1, n_local_pre_refine=1, n_refinement_cycles=0,
        linear_solver="cg", preconditioner="gmg")),
    # two local pre-refinements: the second-finest level is itself a
    # mesh with hanging nodes
    "sneddon_2d_local2": (SNEDDON, dict(
        n_global_pre_refine=1, n_local_pre_refine=2, n_refinement_cycles=0,
        linear_solver="cg", preconditioner="gmg")),
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _prerefined(prm, **over):
    """The port's Simulation after its local pre-refinement (run()'s
    first part), with a System and the mesh-dependent parameters."""
    sim = Simulation(config.load_parameters(prm, output_dir="", **over),
                     device="cpu", verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    n_v = sim.mesh.n_vertices
    z = torch.zeros(n_v * sim.mesh.dim, dtype=torch.float64)
    zp = torch.zeros(n_v, dtype=torch.float64)
    st = SolutionState(u=z, phi=zp, u_old=z, phi_old=zp, phi_oold=zp)
    for _ in range(sim.p.n_local_pre_refine):
        sim.interpolate_initial_values(st)
        st.u_old, st.phi_old, st.phi_oold = st.u, st.phi, st.phi
        sim.refine_mesh(st)
    return sim


def _jax_side(sim, prm, **over):
    """The JAX package's forest, mesh, System (context set as the
    port's) and Galerkin hierarchy on the port's cells."""
    jp = jconfig.load_parameters(prm, **over)
    coarse = (jread_ucd(os.path.join(ROOT, "meshes", "unit_cube_10.inp"),
                        dim=3)
              if jp.test_case == "multiple het"
              else jrect_mesh([-10] * 2, [10] * 2, [10] * 2))
    jf = JForest(coarse)
    jf.root = sim.forest.root.copy()
    jf.level = sim.forest.level.copy()
    jf.anchor = sim.forest.anchor.copy()
    jm = jf.extract()
    bitmap = (jproblems.BitmapField(os.path.join(ROOT, "test.pgm"), 0, 10,
                                    0, 10, jp.E_modulus, 10 * jp.E_modulus)
              if jp.test_case == "multiple het" else None)
    js = JSystem(jp, jm, bitmap)

    def dirichlet_fn(m):
        mu_, _, mp_, _ = jproblems.dirichlet_conditions(jp, m, 0.0,
                                                        initial_step=False)
        return mu_, mp_

    return jf, jm, js, jg.build_galerkin_hierarchy(jf, jm, dirichlet_fn)


def _context(*systems, k, eps):
    for s in systems:
        s.constant_k, s.alpha_eps = k, eps
        s.set_context(time=1.0, timestep=1.0, old_timestep=1.0,
                      old_old_timestep=1.0, use_old_timestep_pf=False,
                      timestep_number=1)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both packages' Systems on one mesh of MESHES, the JAX hierarchy,
    a seeded active set and the JAX package's element matrices at a
    seeded state."""
    prm, over = MESHES[name]
    sim = _prerefined(prm, **over)
    jf, jm, js, jhier = _jax_side(sim, prm, **over)
    _context(js, sim.sys, k=sim.constant_k, eps=sim.alpha_eps)
    assert len(sim.mesh.hang_child) > 0
    rng = np.random.default_rng(7)
    n_v, dim = sim.mesh.n_vertices, sim.mesh.dim
    phi = rng.uniform(0.2, 1.0, n_v)
    state = (rng.normal(scale=1e-3, size=n_v * dim), phi,
             np.minimum(1.0, phi + 0.05), np.minimum(1.0, phi + 0.05))
    active = (rng.uniform(size=n_v) < 0.1) & ~sim.mesh.hanging_mask()
    jac = np.array(jphysics.element_matrices(
        *(jnp.asarray(a) for a in state), js.ca, js.scalars, dim=dim,
        with_split=False, monolithic=False, cell_last=True))
    return dict(name=name, sim=sim, js=js, jhier=jhier, active=active,
                jac=jac, dim=dim)


@pytest.fixture(params=list(MESHES))
def case(request):
    return _case(request.param)


def test_hierarchy_matches_jax(case):
    hier, jhier = case["sim"].sys.galerkin_hierarchy, case["jhier"]
    assert len(hier.levels) == len(jhier.levels) >= 2
    np.testing.assert_array_equal(_np(hier.P_embed), _np(jhier.P_embed))
    hanging_levels = 0
    for lv, jl in zip(hier.levels, jhier.levels):
        np.testing.assert_array_equal(_np(lv.geom.gather_u),
                                      _np(jl.gather_u).T)
        np.testing.assert_array_equal(_np(lv.geom.gather_p),
                                      _np(jl.gather_p).T)
        np.testing.assert_array_equal(_np(jl.fine_idx),
                                      np.arange(len(_np(jl.fine_idx))))
        for f in ("inject_p", "parent_idx", "pos_code", "up_masters_p",
                  "up_weights_p", "up_masters_u", "up_weights_u"):
            np.testing.assert_array_equal(_np(getattr(lv, f)),
                                          _np(getattr(jl, f)), err_msg=f)
        for f in jl.con._fields:
            np.testing.assert_array_equal(_np(getattr(lv.geom.con, f)),
                                          _np(getattr(jl.con, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(_np(lv.geom.con.dirichlet_p),
                                      _np(jl.dirichlet_p))
        hanging_levels += len(_np(jl.con.hang_child_p)) > 0
    assert (hanging_levels > 0) == (case["name"] == "sneddon_2d_local2")
    # the carried-over hierarchy is the port's own
    carried = interop.galerkin_hierarchy(jhier, device=CPU)
    for a, b in zip(carried.levels, hier.levels):
        np.testing.assert_array_equal(_np(a.geom.gather_u),
                                      _np(b.geom.gather_u))
        np.testing.assert_array_equal(_np(a.up_weights_u),
                                      _np(b.up_weights_u))


def _level_ops(case, jac, *, sharp=False):
    """(port level ops, JAX level ops) from the same element matrices."""
    sim, js, jhier = case["sim"], case["js"], case["jhier"]
    dim = case["dim"]
    con_j = js.constraints(0.0)
    build = jax.jit(lambda jac_, act: jg.build_level_ops(
        jhier, jac_, js.ca, act, con_j, dim=dim, sharp=sharp)[0])
    ops_j = build(jnp.asarray(jac), jnp.asarray(case["active"]))
    ops_t, _ = galerkin.build_level_ops(
        sim.sys.galerkin_hierarchy,
        torch.as_tensor(jac).permute(2, 0, 1).contiguous(),
        sim.sys.galerkin_fine, torch.as_tensor(case["active"]), dim=dim,
        sharp=sharp)
    return ops_t, ops_j


def _jax_vcycle(ops_j, dim, which):
    return jax.jit(lambda b: jg.make_vcycle(ops_j, dim=dim, which=which)(b))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_rap_chain_and_vcycle_match_jax(case):
    dim, jac = case["dim"], case["jac"]
    ops_t, ops_j = _level_ops(case, jac)
    assert len(ops_t) == len(ops_j)
    for lt, lj in zip(ops_t, ops_j):
        assert _rel(lt.jac.permute(1, 2, 0), lj.jac) <= 1e-12
        for f in ("free_u", "free_p"):
            np.testing.assert_array_equal(_np(getattr(lt, f)),
                                          _np(getattr(lj, f)))
        for f in ("Dinv_u", "Dinv_p", "lam_u", "lam_p"):
            assert _rel(getattr(lt, f), getattr(lj, f)) <= 1e-12, f
    rng = np.random.default_rng(3)
    for which in ("u", "p"):
        n = len(_np(ops_j[-1].free_u if which == "u" else ops_j[-1].free_p))
        b = rng.normal(size=n)
        y_j = _jax_vcycle(ops_j, dim, which)(jnp.asarray(b))
        y_t = galerkin.make_vcycle(ops_t, dim=dim, which=which)(
            torch.as_tensor(b))
        assert _rel(y_t, y_j) <= 1e-12, which
    # f32: the packages sum f32 terms in different orders
    ops_t, ops_j = _level_ops(case, jac.astype(np.float32))
    for which in ("u", "p"):
        n = len(_np(ops_j[-1].free_u if which == "u" else ops_j[-1].free_p))
        b = rng.normal(size=n).astype(np.float32)
        y_j = _np(_jax_vcycle(ops_j, dim, which)(jnp.asarray(b)))
        y_t = _np(galerkin.make_vcycle(ops_t, dim=dim, which=which)(
            torch.as_tensor(b)))
        assert y_t.dtype == np.float32
        np.testing.assert_allclose(y_t, y_j, rtol=1e-5,
                                   atol=1e-4 * np.abs(y_j).max())


def test_sharp_spectral_estimates_match_jax():
    """On the mesh whose coarse level has hanging nodes."""
    ops_t, ops_j = _level_ops(_case("sneddon_2d_local2"),
                              _case("sneddon_2d_local2")["jac"], sharp=True)
    for lt, lj in zip(ops_t, ops_j):
        for f in ("lam_u", "lam_p"):
            assert _rel(getattr(lt, f), getattr(lj, f)) <= 1e-5, f
        assert lt.rng == float(lj.rng) == 4.0


def test_solve_cg_block_matches_jax():
    """The f64 Galerkin block CG on one Newton system of Sneddon 2d
    refine 3 (19,683 DoFs, a uniform mesh: gmg without mixed precision
    takes the Galerkin hierarchy in both packages)."""
    over = dict(n_global_pre_refine=3, n_local_pre_refine=0,
                n_refinement_cycles=0, linear_solver="cg",
                preconditioner="gmg", cg_rtol=1e-10)
    sim = _prerefined(SNEDDON, **over)
    assert sim.sys.lattice_hierarchy is None
    jf, jm, js, jhier = _jax_side(sim, SNEDDON, **over)
    _context(js, sim.sys, k=sim.constant_k, eps=sim.alpha_eps)
    rng = np.random.default_rng(11)
    n_v = sim.mesh.n_vertices
    phi = rng.uniform(0.2, 1.0, n_v)
    state = (rng.normal(scale=1e-3, size=n_v * 2), phi,
             np.minimum(1.0, phi + 0.05), np.minimum(1.0, phi + 0.05))
    active = rng.uniform(size=n_v) < 0.1
    con_t = sim.sys.constraints(0.0)
    free_u = ~(_np(con_t.dirichlet_u) | _np(con_t.hang_mask_u))
    free_p = ~(_np(con_t.dirichlet_p) | _np(con_t.hang_mask_p)) & ~active
    rhs = (rng.normal(size=n_v * 2) * free_u, rng.normal(size=n_v) * free_p)
    jac = jphysics.element_matrices(
        *(jnp.asarray(a) for a in state), js.ca, js.scalars, dim=2,
        with_split=False, monolithic=False, cell_last=True)
    kw = dict(dim=2, maxiter=3000)
    du_j, dp_j, it_j = jg.solve_cg_block(
        jhier, jac, js.ca, js.constraints(0.0), jnp.asarray(active),
        *(jnp.asarray(r) for r in rhs), 1e-10, 1e-300, chunk=100, **kw)
    du, dp, its = galerkin.solve_cg_block(
        sim.sys.galerkin_hierarchy, torch.as_tensor(np.asarray(jac)),
        sim.sys.galerkin_fine, sim.sys.ca, sim.sys.cell_scatter, con_t,
        torch.as_tensor(active), *(torch.as_tensor(r) for r in rhs), 1e-10,
        1e-300, chunk=100, **kw)
    assert its == int(it_j) > 0
    assert _rel(du, du_j) <= 1e-9 and _rel(dp, dp_j) <= 1e-9


def test_solve_split_matches_jax(monkeypatch):
    """The port with its fused-size threshold at 0 against JAX's split
    run: both take the split solve's target."""
    monkeypatch.setattr(jlat, "FUSED_SOLVE_MAX_DOFS", 0)
    monkeypatch.setattr(galerkin, "FUSED_SOLVE_MAX_DOFS", 0)
    monkeypatch.setenv("CRACKS_TPU_REUSE", "0")
    over = dict(output_dir="", max_no_timesteps=1, linear_solver="cg",
                preconditioner="gmg", mixed_precision_cg=True)
    sim_j, _ = jrun_prm(HETERO, **over)
    calls = []
    orig = galerkin.solve_split

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(galerkin, "solve_split", spy)
    sim, _ = run_prm(HETERO, device="cpu", **over)
    assert sim.sys.galerkin_hierarchy is not None and calls
    dj, dt = sim_j.statistics.data, sim.statistics.data
    assert dt["DoFs"] == dj["DoFs"] == [5288, 5288]
    for col in ("Bulk Energy", "Crack Energy"):
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-6, atol=0,
                                   err_msg=col)
    newton = [e[1] for e in sim.solver_effort]
    assert newton == [e[1] for e in sim_j.solver_effort]
    lin, lin_j = (np.array([e[2] for e in s.solver_effort])
                  for s in (sim, sim_j))
    assert (np.abs(lin - lin_j) <= 2 * np.array(newton)).all(), (lin, lin_j)
    assert sim.step_cuts == 0


def test_multigrid_helpers_match_jax():
    rng = np.random.default_rng(5)
    n, nc = 40, 12
    B = rng.normal(size=(n, n))
    A = B @ B.T + n * np.eye(n)
    Dinv = 1.0 / np.diag(A)
    free = rng.uniform(size=n) < 0.8
    b = rng.normal(size=n)
    masters = rng.integers(0, nc, size=(n, 4))
    weights = rng.uniform(size=(n, 4))
    xc = rng.normal(size=nc)
    jt = lambda *a: tuple(jnp.asarray(x) for x in a)
    tt = lambda *a: tuple(torch.as_tensor(x) for x in a)
    from cracks_tpu_torch.ops.scatter import scatter_table
    np.testing.assert_allclose(
        _np(multigrid._prolong(*tt(xc, masters, weights))),
        _np(jmg._prolong(*jt(xc, masters, weights))), rtol=1e-14)
    np.testing.assert_allclose(
        _np(multigrid._restrict(*tt(b, masters, weights),
                                scatter_table(torch.as_tensor(masters)),
                                nc)),
        _np(jmg._restrict(*jt(b, masters, weights), nc)), rtol=1e-13)
    A_t, f_t, A_j, f_j = (torch.as_tensor(A), torch.as_tensor(free),
                          jnp.asarray(A), jnp.asarray(free))
    op_t = lambda x: torch.where(f_t, A_t @ torch.where(f_t, x, 0.0), 0.0)
    op_j = lambda x: jnp.where(f_j, A_j @ jnp.where(f_j, x, 0.0), 0.0)
    np.testing.assert_allclose(
        _np(multigrid._chebyshev(op_t, torch.as_tensor(Dinv),
                                 torch.as_tensor(b), 3.0, 3, 20.0)),
        _np(jmg._chebyshev(op_j, jnp.asarray(Dinv), jnp.asarray(b), 3.0, 3,
                           rng=20.0)), rtol=1e-13)
    lam_t = float(multigrid.lanczos_lambda_max(
        op_t, torch.as_tensor(Dinv), torch.as_tensor(free)))
    lam_j = float(jmg.lanczos_lambda_max(op_j, jnp.asarray(Dinv),
                                         jnp.asarray(free)))
    assert lam_t == pytest.approx(lam_j, rel=1e-6)
    seed = np.ones(n)
    assert float(multigrid._power_lambda_max(
        op_t, torch.as_tensor(Dinv), torch.as_tensor(seed))) == \
        pytest.approx(float(jmg._power_lambda_max(
            op_j, jnp.asarray(Dinv), jnp.asarray(seed))), rel=1e-12)


def test_level_without_free_dofs_smooths_to_zero():
    """ROADMAP C12: where every phase-field vertex of the coarse levels
    is active, those levels' phase-field blocks have no free dof.  The
    JAX package's Gershgorin bound is then 0 and its Chebyshev smoother
    divides by it (its V-cycle returns NaN, and its split solve a zero
    update); the port's levels take the bound 1 and the V-cycle stays
    finite."""
    case = _case("sneddon_2d_local")
    sim, js, jhier, dim = case["sim"], case["js"], case["jhier"], case["dim"]
    hier = sim.sys.galerkin_hierarchy
    active = np.zeros(sim.mesh.n_vertices, bool)
    for lv in hier.levels:
        active[_np(lv.inject_p)] = True
    case = dict(case, active=active)
    ops_t, ops_j = _level_ops(case, case["jac"])
    assert not _np(ops_t[0].free_p).any() and _np(ops_t[-1].free_p).any()
    assert float(ops_j[0].lam_p) == 0.0 and float(ops_t[0].lam_p) == 1.0
    b = np.random.default_rng(4).normal(size=sim.mesh.n_vertices)
    y_j = _np(_jax_vcycle(ops_j, dim, "p")(jnp.asarray(b)))
    y_t = _np(galerkin.make_vcycle(ops_t, dim=dim, which="p")(
        torch.as_tensor(b)))
    assert np.isnan(y_j).any()
    assert np.isfinite(y_t).all() and np.abs(y_t).max() > 0
