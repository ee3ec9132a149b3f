"""The matrix-free operator of the PyTorch port (`assembled_matvec =
False`) against the JAX package, in f64 on the CPU, from the same
seeded inputs:

- `physics.jacobian_vector_product` (one `torch.func.jvp` of the element
  residual, scattered in order) against JAX's `jax.jvp` within rel
  1e-12 of the largest entry, in 2d with and without the stress split,
  with the monolithic clamps on and off, and in 3d; and against the
  port's own element matrices times the vector;
- the exact and the analytic Jacobi diagonals within rel 1e-12;
- `linear.solve_cg_block` and the matrix-free `newton._solve` (f64,
  and mixed precision: one f32 pass and the f64 correction) on the
  hanging-node problem of tests/test_linear_solvers.py, cg_rtol 1e-10:
  equal iteration counts, the updates within rel 1e-9 (1e-7 with mixed
  precision, whose f32 pass rounds otherwise in the two packages);
- the driver on Sneddon 2d refine 2 (5,043 DoFs, two load steps, cg,
  cg_rtol 1e-8) under the Jacobi CG in f64 and with mixed precision,
  and `miehe_shear_1` under the simple monolithic solver, 3 steps:
  statistics within rel 1e-8 of the JAX runs, equal Newton iterations
  per step, linear iterations within 2 per Newton solve.

The geometric GMG is tests/test_torch_multigrid.py."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu.config import load_parameters as jload_parameters
from cracks_tpu.driver import Simulation as JSimulation
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.meshio import rect_mesh as jrect_mesh
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.ops.constraints import condense_residual as jcondense
from cracks_tpu.solvers import linear as jlinear, newton as jnewton
from cracks_tpu_torch import config, interop
from cracks_tpu_torch.driver import Simulation
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.ops.constraints import condense_residual
from cracks_tpu_torch.ops.scatter import cell_scatter, scatter_add
from cracks_tpu_torch.solvers import linear, newton

from .test_linear_solvers import _setup_hanging_problem

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNEDDON = os.path.join(ROOT, "params", "parameters_sneddon_2d.prm")
MIEHE_SHEAR_1 = os.path.join(ROOT, "params", "tests", "miehe_shear_1.prm")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _problem(dim, *, monolithic, seed=0):
    """Both packages' cell arrays and scalars on a small refined box
    mesh (2d: 6 x 5 roots, refine 1; 3d: 2^3 roots, refine 1), the
    port's scatter tables, and a seeded state and tangent (numpy).  With
    `monolithic` the phase fields dip below 0, so the clamps act."""
    roots = [6, 5] if dim == 2 else [2, 2, 2]
    forest = JForest(jrect_mesh([0.0] * dim, [1.0] * dim, roots))
    forest.refine_global(1)
    mesh = forest.extract()
    jca = jphysics.build_cell_arrays(mesh, 1.5, 0.8)
    jsc = jphysics.make_scalars(
        pressure=1e-3, constant_k=1e-8, alpha_eps=0.3, G_c=1.0,
        gamma_dt=50.0 if monolithic else 0.0, theta=2.0, use_old_pf=0.0,
        decompose_rhs=1.0)
    ca = interop.cell_arrays(jca, device=CPU)
    n_v = mesh.n_vertices
    rng = np.random.default_rng(seed)
    lo = -0.2 if monolithic else 0.0
    phi = rng.uniform(lo, 1.0, n_v)
    state = dict(u=1e-2 * rng.normal(size=n_v * dim), phi=phi,
                 phi_old=np.clip(phi + 0.05 * rng.normal(size=n_v), lo, 1),
                 phi_oold=np.clip(phi + 0.1 * rng.normal(size=n_v), lo, 1),
                 du=rng.normal(size=n_v * dim), dp=rng.normal(size=n_v))
    return dict(dim=dim, jca=jca, jsc=jsc, ca=ca,
                sc=interop.scalars(jsc, device=CPU),
                cs=cell_scatter(ca, n_v * dim, n_v), state=state)


JVP_CASES = [(2, False, False), (2, True, False), (2, False, True),
             (2, True, True), (3, False, False), (3, False, True)]
JVP_IDS = ["2d", "2d-split", "2d-monolithic", "2d-split-monolithic", "3d",
           "3d-monolithic"]


@pytest.mark.parametrize("dim,with_split,monolithic", JVP_CASES,
                         ids=JVP_IDS)
def test_jvp_matches_jax_and_element_matrices(dim, with_split, monolithic):
    pb = _problem(dim, monolithic=monolithic)
    s = pb["state"]
    kw = dict(dim=dim, with_split=with_split, monolithic=monolithic)
    ju_j, jp_j = jphysics.jacobian_vector_product(
        *(jnp.asarray(s[k]) for k in ("u", "phi", "du", "dp", "phi_old",
                                      "phi_oold")),
        pb["jca"], pb["jsc"], **kw)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    ju, jp = physics.jacobian_vector_product(
        t["u"], t["phi"], t["du"], t["dp"], t["phi_old"], t["phi_oold"],
        pb["ca"], pb["sc"], pb["cs"], **kw)
    assert ju.dtype == torch.float64 and ju.device.type == "cpu"
    assert _rel(ju, ju_j) <= 1e-12 and _rel(jp, jp_j) <= 1e-12
    # the element matrices (one-hot jvps of the same residual) times the
    # gathered tangent, scattered in the same order
    ca, cs = pb["ca"], pb["cs"]
    nud_l = ca.gather_p.shape[0] * dim
    jac = physics.element_matrices(t["u"], t["phi"], t["phi_old"],
                                   t["phi_oold"], ca, pb["sc"], **kw)
    x_e = torch.cat([t["du"][ca.gather_u], t["dp"][ca.gather_p]])
    y_e = torch.einsum("ijc,jc->ic", jac, x_e)
    yu = scatter_add(cs.u, y_e[:nud_l], torch.zeros_like(t["u"]))
    yp = scatter_add(cs.p, y_e[nud_l:], torch.zeros_like(t["phi"]))
    assert _rel(ju, yu) <= 1e-12 and _rel(jp, yp) <= 1e-12


@pytest.mark.parametrize("dim,monolithic", [(2, False), (2, True),
                                            (3, False)],
                         ids=["2d", "2d-monolithic", "3d"])
def test_diagonals_match_jax(dim, monolithic):
    pb = _problem(dim, monolithic=monolithic, seed=1)
    s = pb["state"]
    args_j = [jnp.asarray(s[k]) for k in ("u", "phi", "phi_old",
                                          "phi_oold")]
    args = [torch.as_tensor(s[k]) for k in ("u", "phi", "phi_old",
                                            "phi_oold")]
    with_split = dim == 2
    exact_j = jphysics.jacobian_diagonal(
        *args_j, pb["jca"], pb["jsc"], dim=dim, with_split=with_split,
        monolithic=monolithic)
    exact = physics.jacobian_diagonal(
        *args, pb["ca"], pb["sc"], pb["cs"], dim=dim, with_split=with_split,
        monolithic=monolithic)
    approx_j = jphysics.jacobi_diagonal_approx(
        *args_j, pb["jca"], pb["jsc"], dim=dim, monolithic=monolithic)
    approx = physics.jacobi_diagonal_approx(
        *args, pb["ca"], pb["sc"], pb["cs"], dim=dim, monolithic=monolithic)
    for a, b in zip(exact + approx, exact_j + approx_j):
        assert a.dtype == torch.float64
        assert _rel(a, b) <= 1e-12


def _hanging(with_split):
    """The hanging-node problem of tests/test_linear_solvers.py in both
    packages: (JAX pieces, port pieces, rhs numpy pair)."""
    mesh, ca_j, con_j, active_j, u, phi, phi_old, sc_j = \
        _setup_hanging_problem()
    kw = dict(dim=2, with_split=with_split, monolithic=False)
    ru, rp = jphysics.assemble_residual(u, phi, phi_old, phi_old, ca_j, sc_j,
                                        **kw)
    rhs = tuple(_np(r) for r in jcondense(ru, rp, con_j, active_j))
    ca = interop.cell_arrays(ca_j, device=CPU)
    port = dict(ca=ca, sc=interop.scalars(sc_j, device=CPU),
                con=interop.constraints(con_j, device=CPU),
                active=torch.as_tensor(_np(active_j)),
                cs=cell_scatter(ca, mesh.n_vertices * 2, mesh.n_vertices),
                state=[torch.as_tensor(_np(a))
                       for a in (u, phi, phi_old, phi_old)])
    jax_side = dict(ca=ca_j, sc=sc_j, con=con_j, active=active_j,
                    state=[u, phi, phi_old, phi_old])
    return mesh, jax_side, port, rhs


@pytest.mark.parametrize("with_split", [False, True],
                         ids=["no-split", "split"])
def test_solve_cg_block_matches_jax(with_split):
    _, js, pt, rhs = _hanging(with_split)
    kw = dict(dim=2, with_split=with_split, monolithic=False)
    d_j = jphysics.jacobi_diagonal_approx(*js["state"], js["ca"], js["sc"],
                                          dim=2, monolithic=False)
    du_j, dp_j, it_j = jlinear.solve_cg_block(
        *js["state"], js["ca"], js["sc"], js["con"], js["active"],
        *(jnp.asarray(r) for r in rhs), *d_j, 1e-10, 1e-300, maxiter=2000,
        **kw)
    d = physics.jacobi_diagonal_approx(*pt["state"], pt["ca"], pt["sc"],
                                       pt["cs"], dim=2, monolithic=False)
    du, dp, its = linear.solve_cg_block(
        *pt["state"], pt["ca"], pt["sc"], pt["cs"], pt["con"], pt["active"],
        *(torch.as_tensor(r) for r in rhs), *d, 1e-10, 1e-300, maxiter=2000,
        **kw)
    assert its == int(it_j) > 10
    assert _rel(du, du_j) <= 1e-9 and _rel(dp, dp_j) <= 1e-9


@pytest.mark.parametrize("mixed,bound", [(False, 1e-9), (True, 1e-7)],
                         ids=["f64", "mixed"])
def test_matrix_free_solve_matches_jax(mixed, bound):
    """newton._solve routed to the matrix-free Jacobi CG (cg, no
    hierarchy, assembled_matvec = False) in both packages, on a
    System-like bundle of the hanging-node problem.  With mixed
    precision the f32 pass rounds otherwise in the two packages (its
    updates agree to ~3e-6), and the f64 correction removes that
    difference only where the residual sees it: the updates agree to
    ~1e-8, at any cg_rtol, with equal iteration counts in both passes."""
    mesh, js, pt, rhs = _hanging(with_split=True)
    over = dict(linear_solver="cg", preconditioner="jacobi",
                assembled_matvec=False, cg_rtol=1e-10, cg_maxiter=2000,
                cg_chunk=100, mixed_precision_cg=mixed)
    jsys = SimpleNamespace(
        params=jload_parameters(SNEDDON, **over), mesh=mesh, dim=2,
        ca=js["ca"], scalars=js["sc"], monolithic=False,
        mixed_precision=mixed,
        ca32=jphysics.CellArrays(*(
            jnp.asarray(a, jnp.float32) if isinstance(a, jnp.ndarray)
            and a.dtype == jnp.float64 else a for a in js["ca"])))
    du_j, dp_j, it_j = jnewton._solve(
        jsys, *js["state"], js["con"], js["active"],
        *(jnp.asarray(r) for r in rhs), True)
    tsys = SimpleNamespace(
        params=config.load_parameters(SNEDDON, **over), mesh=mesh, dim=2,
        ca=pt["ca"], scalars=pt["sc"], monolithic=False,
        mixed_precision=mixed, cell_scatter=pt["cs"],
        ca32=physics.CellArrays(*(
            a.to(torch.float32) if a.is_floating_point() else a
            for a in pt["ca"])),
        lattice_hierarchy=None, galerkin_hierarchy=None, hierarchy=None)
    assert newton.check_linear_solver(tsys) == "matrix-free"
    du, dp, its = newton._solve(tsys, *pt["state"], pt["con"], pt["active"],
                                *(torch.as_tensor(r) for r in rhs), True)
    assert its == int(it_j) > 10
    assert _rel(du, du_j) <= bound and _rel(dp, dp_j) <= bound


def _agree(sim, sim_j, columns):
    dt, dj = sim.statistics.data, sim_j.statistics.data
    assert dt["DoFs"] == dj["DoFs"]
    for col in columns:
        np.testing.assert_allclose(dt[col], dj[col], rtol=1e-8, atol=0,
                                   err_msg=col)
    newton_its = [e[1] for e in sim.solver_effort]
    assert newton_its == [e[1] for e in sim_j.solver_effort]
    lin, lin_j = (np.array([e[2] for e in s.solver_effort])
                  for s in (sim, sim_j))
    assert (np.abs(lin - lin_j) <= 2 * np.array(newton_its)).all(), (
        lin, lin_j)
    assert sim.step_cuts == 0


SNEDDON_R2 = dict(n_global_pre_refine=2, n_local_pre_refine=0,
                  n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
                  linear_solver="cg", preconditioner="jacobi", cg_rtol=1e-8,
                  cg_maxiter=3000, dtype="float64", assembled_matvec=False)


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_sneddon_refine2_matches_jax(mixed):
    over = dict(SNEDDON_R2, mixed_precision_cg=mixed)
    sim_j = JSimulation(jload_parameters(SNEDDON, **over), verbose=False)
    sim_j.run()
    sim = Simulation(config.load_parameters(SNEDDON, **over), device="cpu",
                     verbose=False)
    sim.run()
    assert newton.check_linear_solver(sim.sys) == "matrix-free"
    assert sim.mesh.n_dofs == 5043
    _agree(sim, sim_j, ("Bulk Energy", "Crack Energy"))


def test_miehe_shear_1_monolithic_matches_jax():
    """The penalized monolithic Newton on the matrix-free Jacobi CG (the
    split, the gamma schedule), 3 steps."""
    over = dict(output_dir="", max_no_timesteps=2,
                outer_solver="simple monolithic", linear_solver="cg",
                assembled_matvec=False)
    sim_j = JSimulation(jload_parameters(MIEHE_SHEAR_1, **over),
                        verbose=False)
    sim_j.run()
    sim = Simulation(config.load_parameters(MIEHE_SHEAR_1, **over),
                     device="cpu", verbose=False)
    sim.run()
    assert sim.sys.monolithic
    assert newton.check_linear_solver(sim.sys) == "matrix-free"
    _agree(sim, sim_j, ("Bulk Energy", "Crack Energy", "Load x"))
