"""Element kernel, cell geometry and QoI reductions of the PyTorch port
against the JAX package, f64, in 2d (a refine-2 Sneddon lattice, 41x41
vertices) and 3d (a 6x6x6-cell lattice over the Sneddon box: 8
quadrature points, 32 local dofs).  Inputs come from a seeded numpy
generator and reach both packages through cracks_tpu_torch.interop.

Tolerance: rtol 1e-12 and atol 1e-12 * max|reference| — the two
packages sum the same f64 terms in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import meshio, problems, qoi as jqoi
from cracks_tpu.config import Parameters
from cracks_tpu.mesh import Forest
from cracks_tpu.ops import physics as jphys
from cracks_tpu.solvers import lattice as jlat
from cracks_tpu_torch import interop, qoi
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.ops.scatter import cell_scatter

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _close(a, ref, rtol=1e-12):
    ref = np.asarray(ref)
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


# dim -> (root subdivisions per axis, global refinements)
MESHES = {2: (10, 2), 3: (3, 1)}


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def setup(request):
    dim = request.param
    reps, refine = MESHES[dim]
    f = Forest(meshio.rect_mesh([-10] * dim, [10] * dim, [reps] * dim))
    f.refine_global(refine)
    mesh = f.extract()
    p = Parameters(test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
                   poisson_ratio_nu=0.2, E_modulus=1.0)
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    lay = jlat.detect_tensor_grid(mesh)
    core = jphys.build_cell_core(mesh, lam, mu)
    ca = jphys.cell_arrays_from_core(core, dtype=jnp.float64, chunk=False)
    rng = np.random.default_rng(7)
    n_v = mesh.n_vertices
    state = dict(u=rng.normal(size=n_v * dim) * 1e-2,
                 phi=rng.uniform(-0.2, 1.0, n_v),
                 phi_old=rng.uniform(-0.2, 1.0, n_v),
                 phi_oold=rng.uniform(-0.2, 1.0, n_v))
    sc = jphys.make_scalars(0.5, 1e-2, 0.7, 1.0, 3.0, 1.5, 0.0, 0.0)
    return dict(dim=dim, mesh=mesh, lam=lam, mu=mu, lay=lay, core=core,
                ca=ca, state=state, sc=sc)


def _port_inputs(s):
    st = s["state"]
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in st.items()}
    return (t, interop.cell_arrays(s["ca"], device=CPU),
            interop.scalars(s["sc"], device=CPU))


def test_cell_core_and_raster_cell_arrays_match_jax(setup):
    s = setup
    core_t = physics.build_cell_core(s["mesh"], s["lam"], s["mu"],
                                     device=CPU)
    perm = s["lay"].cell_perm
    for dt, jdt in ((torch.float64, jnp.float64),
                    (torch.float32, jnp.float32)):
        ref = jphys.cell_arrays_from_core(s["core"], dtype=jdt, chunk=False,
                                          perm=perm)
        got = physics.cell_arrays_from_core(core_t, dt, perm=perm)
        for name in physics.CellArrays._fields:
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert tuple(a.shape) == b.shape, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("monolithic", [False, True])
def test_assemble_residual_matches_jax(setup, monolithic):
    s = setup
    st = {k: jnp.asarray(v) for k, v in s["state"].items()}
    ru_j, rp_j = jphys.assemble_residual(
        st["u"], st["phi"], st["phi_old"], st["phi_oold"], s["ca"], s["sc"],
        dim=s["dim"], with_split=False, monolithic=monolithic)
    t, ca, sc = _port_inputs(s)
    cs = cell_scatter(ca, t["u"].numel(), t["phi"].numel())
    ru, rp = physics.assemble_residual(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, cs,
        dim=s["dim"], with_split=False, monolithic=monolithic)
    _close(ru, ru_j)
    _close(rp, rp_j)


@pytest.mark.parametrize("monolithic", [False, True])
def test_element_matrices_match_jax(setup, monolithic):
    s = setup
    st = {k: jnp.asarray(v) for k, v in s["state"].items()}
    jac_j = jphys.element_matrices(
        st["u"], st["phi"], st["phi_old"], st["phi_oold"], s["ca"], s["sc"],
        dim=s["dim"], with_split=False, monolithic=monolithic,
        cell_last=True)
    t, ca, sc = _port_inputs(s)
    jac = physics.element_matrices(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, dim=s["dim"],
        with_split=False, monolithic=monolithic)
    ndl = 2 ** s["dim"] * (s["dim"] + 1)
    assert tuple(jac.shape) == (ndl, ndl, s["mesh"].n_cells)
    _close(jac, jac_j)


@pytest.mark.parametrize("per_pass", [1, 5])
def test_element_matrices_equal_for_any_tangents_per_pass(setup, per_pass,
                                                          monkeypatch):
    """The element build's vmapped passes of `per_pass` one-hot tangents
    (one, as a mesh of 2^18 cells or more takes them, or five, which
    leaves a short last pass) give the same bits as one pass of all
    ndl (this mesh's default); with the split in 2d."""
    s = setup
    t, ca, sc = _port_inputs(s)
    n_c = s["mesh"].n_cells
    build = lambda: physics.element_matrices(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, dim=s["dim"],
        with_split=s["dim"] == 2, monolithic=False)
    ndl = 2 ** s["dim"] * (s["dim"] + 1)
    assert physics.JVP_BATCH_CELL_TANGENTS // n_c >= ndl
    whole = build()
    monkeypatch.setattr(physics, "JVP_BATCH_CELL_TANGENTS", per_pass * n_c)
    torch.testing.assert_close(build(), whole, rtol=0, atol=0)


def test_spectral_split_raises(setup):
    """The split is 2d-only, as in the reference: in 3d it raises; in
    2d the split residual equals the JAX package's."""
    s = setup
    t, ca, sc = _port_inputs(s)
    cs = cell_scatter(ca, t["u"].numel(), t["phi"].numel())
    run = lambda: physics.assemble_residual(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, cs,
        dim=s["dim"], with_split=True, monolithic=False)
    if s["dim"] == 3:
        with pytest.raises(ValueError, match="2d-only"):
            run()
        return
    st = {k: jnp.asarray(v) for k, v in s["state"].items()}
    ru_j, rp_j = jphys.assemble_residual(
        st["u"], st["phi"], st["phi_old"], st["phi_oold"], s["ca"], s["sc"],
        dim=2, with_split=True, monolithic=False)
    ru, rp = run()
    _close(ru, ru_j)
    _close(rp, rp_j)


def test_energy_tcv_and_linf_match_jax(setup):
    s = setup
    dim = s["dim"]
    st = {k: jnp.asarray(v) for k, v in s["state"].items()}
    lam_e, mu_e = jnp.asarray(s["lam"]), jnp.asarray(s["mu"])
    ref = jqoi.energy_tcv_device(st["u"], st["phi"], s["ca"], lam_e, mu_e,
                                 1e-2, 0.7, 1.0, dim=dim)
    t, ca, _ = _port_inputs(s)
    got = qoi.energy_tcv_device(
        t["u"], t["phi"], ca, torch.as_tensor(s["lam"]),
        torch.as_tensor(s["mu"]), 1e-2, 0.7, 1.0, dim=dim)
    for a, b in zip(got, ref):
        _close(a, b)
    rng = np.random.default_rng(3)
    u_old = t["u"] + torch.as_tensor(rng.normal(size=t["u"].shape))
    linf = qoi.linf_diff_device(t["u"], u_old, t["phi"], t["phi_old"])
    linf_j = jqoi.linf_diff_device(st["u"], jnp.asarray(u_old.numpy()),
                                   st["phi"], st["phi_old"])
    assert float(linf) == float(linf_j)
    # the host references are copies; pin them against the originals
    assert qoi.tcv_exact(dim, 1e-3, 0.2) == jqoi.tcv_exact(dim, 1e-3, 0.2)
    phi = s["state"]["phi"]
    assert (qoi.sneddon_phi_l2_error(s["mesh"], phi, 0.7)
            == jqoi.sneddon_phi_l2_error(s["mesh"], phi, 0.7))
