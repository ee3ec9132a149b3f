"""The port's Miehe spectral split (cracks_tpu_torch/ops/spectral.py)
and the split branch of its element kernel against the JAX package, f64.

- the split functions (eigen_2x2_sym, stress_split_components,
  stress_split_2d, full_stress) and their forward-mode derivatives
  (torch.func.jvp against jax.jvp) at the gates' edge cases: E = 0,
  isotropic strains of either sign, near-diagonal strains
  (|b| = 1e-11 |a|, a != c), an eigenvalue or the trace exactly 0, and
  seeded random strains, to rel 1e-12, every value finite (a
  near-isotropic strain just outside the degenerate gate, such as
  (4e-3, 4e-14; 4e-14, 4e-3), is left out: there the tangent's
  condition number is |a|/(l1 - l2) ~ 5e10 and the two packages'
  derivative rules round 3e-11 apart);
- the element residual and the element matrices with with_split=True
  on the slit mesh (two global refinements) with a seeded state that
  leaves part of the cells at exactly zero strain, where the square
  root's tangent is not finite in the branch the gate drops.

Tolerance: rtol 1e-12 and atol 1e-12 * max|reference| (the two packages
sum the same f64 terms in different orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu import meshio, problems
from cracks_tpu.config import load_parameters
from cracks_tpu.mesh import Forest
from cracks_tpu.ops import physics as jphys
from cracks_tpu.ops import spectral as jspec
from cracks_tpu_torch import interop
from cracks_tpu_torch.ops import physics, spectral
from cracks_tpu_torch.ops.scatter import cell_scatter

from .regression import MESH_DIR, PRM_DIR

torch.set_num_threads(1)
RTOL = 1e-12


def _close(a, ref, rtol=RTOL):
    ref = np.asarray(ref)
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    assert np.isfinite(a).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(a, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _strains():
    """(name, (n, 2, 2) symmetric strains) at the gates' edge cases."""
    rng = np.random.default_rng(11)
    sym = lambda a, b, c: np.array([[a, b], [b, c]], dtype=np.float64)
    rnd = rng.normal(scale=1e-3, size=(64, 3))
    return [
        ("zero", np.zeros((1, 2, 2))),
        ("isotropic", np.stack([sym(2e-3, 0.0, 2e-3),
                                sym(-3e-3, 0.0, -3e-3)])),
        ("near_diagonal", np.stack([sym(1e-3, 1e-14, -5e-4),
                                    sym(-2e-3, -2e-14, 7e-4)])),
        # eigenvalues (5, 0) of (1, 2; 2, 4), (1, 0) and a trace of 0
        ("zero_eigenvalue", np.stack([sym(1.0, 2.0, 4.0) * 1e-3,
                                      sym(1e-3, 0.0, 0.0),
                                      sym(-1.0, -2.0, -4.0) * 1e-3,
                                      sym(1e-3, 5e-4, -1e-3)])),
        ("random", np.stack([sym(*r) for r in rnd])),
    ]


STRAINS = _strains()
IDS = [name for name, _ in STRAINS]


def _tangent(E, seed):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=E.shape)
    return 0.5 * (t + np.swapaxes(t, -1, -2))


@pytest.mark.parametrize("case", STRAINS, ids=IDS)
def test_eigen_2x2_sym_matches_jax(case):
    _, E = case
    ref = jspec.eigen_2x2_sym(jnp.asarray(E))
    got = spectral.eigen_2x2_sym(torch.as_tensor(E))
    for a, b in zip(got, ref):
        _close(a, b)
    dE = _tangent(E, 1)
    _, dref = jax.jvp(jspec.eigen_2x2_sym, (jnp.asarray(E),),
                      (jnp.asarray(dE),))
    _, dgot = torch.func.jvp(spectral.eigen_2x2_sym, (torch.as_tensor(E),),
                             (torch.as_tensor(dE),))
    for a, b in zip(dgot, dref):
        _close(a, b)


@pytest.mark.parametrize("case", STRAINS, ids=IDS)
def test_stress_split_2d_and_jvp_match_jax(case):
    _, E = case
    lam, mu = 121.15e3, 80.77e3
    jf = lambda e: jspec.stress_split_2d(e, lam, mu)
    tf = lambda e: spectral.stress_split_2d(e, lam, mu)
    for got, ref in zip(tf(torch.as_tensor(E)), jf(jnp.asarray(E))):
        _close(got, ref)
    for seed in (2, 3):
        dE = _tangent(E, seed)
        _, dref = jax.jvp(jf, (jnp.asarray(E),), (jnp.asarray(dE),))
        _, dgot = torch.func.jvp(tf, (torch.as_tensor(E),),
                                 (torch.as_tensor(dE),))
        for a, b in zip(dgot, dref):
            _close(a, b)
    sp, sm = tf(torch.as_tensor(E))
    _close(sp + sm, jspec.full_stress(jnp.asarray(E), lam, mu))
    _close(spectral.full_stress(torch.as_tensor(E), lam, mu),
           jspec.full_stress(jnp.asarray(E), lam, mu))


@pytest.mark.parametrize("case", STRAINS, ids=IDS)
def test_stress_split_components_and_jvp_match_jax(case):
    """The element kernel's form, with per-entry Lame coefficients."""
    _, E = case
    n = E.shape[0]
    rng = np.random.default_rng(4)
    lam = rng.uniform(1.0, 2.0, n)
    mu = rng.uniform(0.5, 1.0, n)
    comps = lambda E: (E[:, 0, 0], E[:, 0, 1], E[:, 1, 1])
    jf = lambda a, b, c: jspec.stress_split_components(
        a, b, c, jnp.asarray(lam), jnp.asarray(mu))
    tf = lambda a, b, c: spectral.stress_split_components(
        a, b, c, torch.as_tensor(lam), torch.as_tensor(mu))
    ref = jf(*(jnp.asarray(x) for x in comps(E)))
    got = tf(*(torch.as_tensor(x) for x in comps(E)))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            _close(a, b)
    dE = _tangent(E, 5)
    _, dref = jax.jvp(jf, tuple(jnp.asarray(x) for x in comps(E)),
                      tuple(jnp.asarray(x) for x in comps(dE)))
    _, dgot = torch.func.jvp(tf, tuple(torch.as_tensor(x) for x in comps(E)),
                             tuple(torch.as_tensor(x) for x in comps(dE)))
    for g, r in zip(dgot, dref):
        for a, b in zip(g, r):
            _close(a, b)


@pytest.fixture(scope="module")
def slit():
    """The slit mesh at two global refinements, miehe_shear_1's
    material, a seeded state whose displacement is zero right of
    x = 0.6 (cells at exactly zero strain) and the scalars with
    decompose_rhs = 1."""
    f = Forest(meshio.read_ucd(os.path.join(MESH_DIR, "unit_slit.inp"),
                               dim=2))
    f.refine_global(2)
    mesh = f.extract()
    p = load_parameters(os.path.join(PRM_DIR, "miehe_shear_1.prm"))
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    core = jphys.build_cell_core(mesh, lam, mu)
    ca = jphys.cell_arrays_from_core(core, dtype=jnp.float64, chunk=False)
    rng = np.random.default_rng(9)
    n_v = mesh.n_vertices
    u = rng.normal(scale=1e-3, size=(n_v, 2))
    u[mesh.vert_coords[:, 0] > 0.6] = 0.0
    state = dict(u=u.reshape(-1), phi=rng.uniform(0.0, 1.0, n_v),
                 phi_old=rng.uniform(0.0, 1.0, n_v),
                 phi_oold=rng.uniform(0.0, 1.0, n_v))
    sc = jphys.make_scalars(0.0, 1e-10, 0.18, 2.7, 0.0, 2.0, 0.0, 1.0)
    return dict(mesh=mesh, ca=ca, state=state, sc=sc)


def _both(s):
    st = s["state"]
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in st.items()}
    cpu = torch.device("cpu")
    return (jst, tst, interop.cell_arrays(s["ca"], device=cpu),
            interop.scalars(s["sc"], device=cpu))


def test_split_residual_matches_jax(slit):
    jst, t, ca, sc = _both(slit)
    ru_j, rp_j = jphys.assemble_residual(
        jst["u"], jst["phi"], jst["phi_old"], jst["phi_oold"], slit["ca"],
        slit["sc"], dim=2, with_split=True, monolithic=False)
    cs = cell_scatter(ca, t["u"].numel(), t["phi"].numel())
    ru, rp = physics.assemble_residual(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, cs, dim=2,
        with_split=True, monolithic=False)
    _close(ru, ru_j)
    _close(rp, rp_j)


def test_split_element_matrices_match_jax(slit):
    jst, t, ca, sc = _both(slit)
    jac_j = jphys.element_matrices(
        jst["u"], jst["phi"], jst["phi_old"], jst["phi_oold"], slit["ca"],
        slit["sc"], dim=2, with_split=True, monolithic=False,
        cell_last=True)
    jac = physics.element_matrices(
        t["u"], t["phi"], t["phi_old"], t["phi_oold"], ca, sc, dim=2,
        with_split=True, monolithic=False)
    assert tuple(jac.shape) == (12, 12, slit["mesh"].n_cells)
    # the zero-strain cells are there, and their columns are finite
    u_e = t["u"].reshape(-1, 2)[torch.as_tensor(slit["mesh"].cell2vert)]
    assert int((u_e.abs().amax(dim=(1, 2)) == 0).sum()) > 0
    _close(jac, jac_j)
