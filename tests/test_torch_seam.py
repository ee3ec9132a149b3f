"""The seam lattice of the PyTorch port (cracks_tpu_torch/solvers/
lattice.py: `Seam` and its helpers) against the JAX package's, on the
reference's slit mesh `unit_slit.inp` at global refinement 3 and 4, in
f64 on the CPU, with the Miehe shear material of miehe_shear_2.prm and
a seeded state:

(a) detection: grid, vertex ids and positions, cell raster and seam
    equal; the hierarchy's per-level Dirichlet masks (mirror slots
    pinned) equal; the dead raster row has a zero JxW, zero element
    matrices and a zero residual;
(b) seam_spread / seam_collect equal the JAX package's bit for bit and
    are adjoint on canonical vectors;
(c) the seam product, spread -> plain stencil -> collect, equals the JAX
    package's and the assembled operator of the slit mesh (u block,
    phase-field block, J_pu) to rel 1e-12, with and without the split;
    so does the conjugated residual;
(d) prolong_seam / restrict_seam and coarsen_seam equal the JAX
    package's (rel 1e-12) and the transfer pair is adjoint;
(e) `_prepare_levels` with the seam equals the JAX package's on the
    cast f32 chain: free masks exactly, the Jacobi scaling, the spectral
    bounds and the coarse factor, and one V-cycle on a seeded residual,
    within the f32 bounds of tests/test_pallas_stencil.py (rtol 1e-5,
    atol 1e-4 of the largest value)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cracks_tpu.solvers.lattice as jlat
from cracks_tpu import problems as jproblems
from cracks_tpu.config import load_parameters as jload
from cracks_tpu.mesh import Forest as JForest
from cracks_tpu.meshio import read_ucd as jread_ucd
from cracks_tpu.ops import physics as jphysics
from cracks_tpu.solvers import galerkin as jgalerkin
from cracks_tpu_torch import config, interop, mesh as tmesh, meshio, problems
from cracks_tpu_torch.ops import physics
from cracks_tpu_torch.ops.scatter import cell_scatter
from cracks_tpu_torch.solvers import assembled, lattice

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(ROOT, "params", "tests", "miehe_shear_2.prm")
SLIT = os.path.join(meshio.MESH_DIR, "unit_slit.inp")
# (refinement, grid, seam, levels)
SLITS = {3: ((18, 17), (8, 9), 2), 4: ((34, 33), (16, 17), 3)}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module", params=sorted(SLITS), ids=lambda r: f"r{r}")
def slit(request):
    """Both packages' meshes, layouts, hierarchies, cell arrays and f64
    element matrices (with and without the split) at a seeded state."""
    refine = request.param
    jp, tp = jload(PRM), config.load_parameters(PRM)
    jf = JForest(jread_ucd(SLIT, dim=2))
    jf.refine_global(refine)
    jmesh = jf.extract()
    tf = tmesh.Forest(meshio.read_ucd(SLIT, dim=2))
    tf.refine_global(refine)
    mesh = tf.extract()
    jlay = jlat.detect_tensor_grid(jmesh)
    lay = lattice.detect_tensor_grid(mesh)

    def dir_fn(prob, p):
        def f(m):
            mu_, _, mp_, _ = prob.dirichlet_conditions(p, m, 0.0,
                                                       initial_step=False)
            return mu_, mp_
        return f

    jhier = jlat.build_lattice_hierarchy(jmesh, jlay,
                                         dir_fn(jproblems, jp))
    hier = lattice.build_lattice_hierarchy(mesh, lay, dir_fn(problems, tp),
                                           device=CPU)
    lam, mu = jproblems.cell_lame_fields(jp, jmesh, None)
    jcaL = jlat.permuted_cell_arrays(jmesh, lam, mu, jlay,
                                     dtype=jnp.float64)
    tlam, tmu = problems.cell_lame_fields(tp, mesh, None)
    core = physics.build_cell_core(mesh, tlam, tmu, device=CPU)
    ca = physics.cell_arrays_from_core(core, torch.float64)
    caL = physics.cell_arrays_from_core(core, torch.float64,
                                        perm=lay.cell_perm)
    sc_args = (0.0, 1e-10, 0.05, 2.7, 0.0, 1.0, 0.0, 1.0)
    jsc = jphysics.make_scalars(*sc_args, dtype=jnp.float64)
    sc = physics.make_scalars(*sc_args, dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(refine)
    nv = mesh.n_vertices
    u = 1e-4 * rng.standard_normal(nv * 2)
    phi = rng.uniform(0.3, 1.0, nv)
    vp = hier.vert_pos
    state = [lattice.seam_spread(lattice._to_lat(_t(x), vp, lay.grid, k),
                                 lay.seam)
             for x, k in ((u, 2), (phi, 1), (phi, 1), (phi, 1))]
    jac, jjac = {}, {}
    for split in (False, True):
        kw = dict(dim=2, with_split=split, monolithic=False)
        jac[split] = lattice.element_matrices_lattice(*state, caL, sc, **kw)
        jjac[split] = jphysics.element_matrices(
            jnp.asarray(u), jnp.asarray(phi), jnp.asarray(phi),
            jnp.asarray(phi), jcaL, jsc, cell_last=True, **kw).reshape(
                jac[split].shape)
    return dict(refine=refine, jmesh=jmesh, mesh=mesh, jlay=jlay, lay=lay,
                jhier=jhier, hier=hier, ca=ca, caL=caL, sc=sc, u=u, phi=phi,
                state=state, jac=jac, jjac=jjac, rng=rng)


def _canonical(rng, k, grid, seam):
    X = rng.standard_normal((k,) + tuple(grid))
    X[:, seam.s + 1, :seam.slit_lo] = 0.0
    return X


def test_detect_and_hierarchy_match_jax(slit):
    """(a)"""
    grid, seam, n_levels = SLITS[slit["refine"]]
    jlay, lay = slit["jlay"], slit["lay"]
    assert lay.grid == jlay.grid == grid
    assert tuple(lay.seam) == tuple(jlay.seam) == seam
    assert isinstance(lay.seam, lattice.Seam)
    for name in ("vert_idx", "vert_pos", "cell_perm"):
        np.testing.assert_array_equal(getattr(lay, name),
                                      getattr(jlay, name))
    cg = (grid[0] - 1, grid[1] - 1)
    dead = lay.cell_perm.reshape(cg) < 0
    assert dead[seam[0]].all() and dead.sum() == cg[1]
    hier, jhier = slit["hier"], slit["jhier"]
    assert hier.n_levels == jhier.n_levels == n_levels
    assert tuple(hier.seam) == jhier.seam
    for a, b in zip(hier.dir_u + hier.dir_p, jhier.dir_u + jhier.dir_p):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the mirror slots are pinned on every level
    for sm, du in zip(lattice.seam_levels(hier.seam, n_levels), hier.dir_u):
        assert bool(du[:, sm.s + 1, :sm.slit_lo].all())
    # the interop carrier keeps the seam
    assert interop.lattice_hierarchy(jhier, device=CPU).seam == hier.seam
    # the dead raster row: zero JxW, zero element matrices and residual
    JxW = _np(slit["caL"].JxW).reshape((-1,) + cg)
    assert (JxW[:, seam[0]] == 0).all() and (JxW[:, ~dead] > 0).all()
    for split in (False, True):
        assert float(slit["jac"][split][:, :, seam[0]].abs().max()) == 0.0
    ru_e, rp_e = physics._element_residual_cl(
        *lattice._cell_windows(*slit["state"], 2), slit["caL"], slit["sc"],
        dim=2, with_split=True, monolithic=False)
    assert float(ru_e.reshape(4, 2, *cg)[..., seam[0], :].abs().max()) == 0
    assert float(rp_e.reshape(4, *cg)[:, seam[0]].abs().max()) == 0


def test_spread_collect_match_jax_and_adjoint(slit):
    """(b)"""
    seam = slit["lay"].seam
    rng = slit["rng"]
    for k in (1, 2):
        X = rng.standard_normal((k,) + slit["lay"].grid)
        for f, jf in ((lattice.seam_spread, jlat.seam_spread),
                      (lattice.seam_collect, jlat.seam_collect)):
            np.testing.assert_array_equal(_np(f(_t(X), seam)),
                                          _np(jf(jnp.asarray(X),
                                                 slit["jlay"].seam)))
        Xc = _canonical(rng, k, slit["lay"].grid, seam)
        Y = rng.standard_normal(Xc.shape)
        lhs = float(torch.sum(lattice.seam_spread(_t(Xc), seam) * _t(Y)))
        rhs = float(torch.sum(_t(Xc) * lattice.seam_collect(_t(Y), seam)))
        assert abs(lhs - rhs) <= 1e-12 * (abs(lhs) + 1)
    assert lattice.seam_spread(X, None) is X
    assert lattice.seam_collect(X, None) is X


@pytest.mark.parametrize("split", [False, True], ids=["no-split", "split"])
def test_seam_product_matches_jax_and_assembled(slit, split):
    """(c)"""
    lay, seam, vp = slit["lay"], slit["lay"].seam, slit["hier"].vert_pos
    jac, jjac = slit["jac"][split], slit["jjac"][split]
    np.testing.assert_allclose(_np(jac), _np(jjac), rtol=1e-12,
                               atol=1e-12 * float(jac.abs().max()))
    mesh, ca, sc = slit["mesh"], slit["ca"], slit["sc"]
    nv = mesh.n_vertices
    kw = dict(dim=2, with_split=split, monolithic=False)
    jac_flat = physics.element_matrices(_t(slit["u"]), _t(slit["phi"]),
                                        _t(slit["phi"]), _t(slit["phi"]),
                                        ca, sc, **kw)
    cs = cell_scatter(ca, nv * 2, nv)
    rng = slit["rng"]
    x = _t(rng.standard_normal(nv * 2))
    xp = _t(rng.standard_normal(nv))
    lat = lambda v, k: lattice._to_lat(v, vp, lay.grid, k)
    glob = lambda Y, k: lattice._to_glob(Y, vp, k)
    for name, xin, k_in, rows, cols, ref in (
            ("u", x, 2, (0, 8), (0, 8), assembled.matvec_uu(
                jac_flat, ca, x, cs, dim=2)),
            ("phi", xp, 1, (8, 12), (8, 12), assembled.matvec_pp(
                jac_flat, ca, xp, cs, dim=2)),
            ("J_pu", x, 2, (8, 12), (0, 8), assembled.matvec_pu(
                jac_flat, ca, x, cs, dim=2))):
        k_out = 2 if name == "u" else 1
        X = lat(xin, k_in)
        Y = lattice.seam_collect(lattice.matvec_block(
            jac, lattice.seam_spread(X, seam), *rows, *cols, k_in, k_out),
            seam)
        jY = jlat.seam_collect(jlat.matvec_block(
            jjac, jlat.seam_spread(jnp.asarray(_np(X)), slit["jlay"].seam),
            *rows, *cols, k_in, k_out), slit["jlay"].seam)
        scale = float(ref.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(_np(Y), _np(jY), rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=name)
        np.testing.assert_allclose(_np(glob(Y, k_out)), _np(ref),
                                   rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=name)
        # canonical: nothing left in the mirror slots
        assert float(Y[:, seam.s + 1, :seam.slit_lo].abs().max()) == 0.0
    # the conjugated residual of the lattice Newton
    from cracks_tpu_torch.solvers.lattice_newton import _lat_residual_seam
    canon = [X.clone() for X in slit["state"]]
    for X in canon:
        X[:, seam.s + 1, :seam.slit_lo] = 0.0
    RU, RP = _lat_residual_seam(*canon, slit["caL"], sc, seam=seam, **kw)
    ru, rp = physics.assemble_residual(_t(slit["u"]), _t(slit["phi"]),
                                       _t(slit["phi"]), _t(slit["phi"]), ca,
                                       sc, cs, **kw)
    for R, r, k in ((RU, ru, 2), (RP, rp, 1)):
        np.testing.assert_allclose(_np(glob(R, k)), _np(r), rtol=1e-12,
                                   atol=1e-12 * float(r.abs().max()))


def test_transfer_and_coarsening_match_jax(slit):
    """(d)"""
    lay, seam, jseam = slit["lay"], slit["lay"].seam, slit["jlay"].seam
    grid_f = lay.grid
    grid_c = lattice._seam_coarse_grid(grid_f, seam)
    assert grid_c == jlat._seam_coarse_grid(grid_f, jseam)
    sc_ = lattice.seam_coarse(seam)
    rng = slit["rng"]
    for k in (1, 2):
        Xc = _canonical(rng, k, grid_c, sc_)
        Yf = _canonical(rng, k, grid_f, seam)
        P = lattice.prolong_seam(_t(Xc), grid_f, k, seam)
        R = lattice.restrict_seam(_t(Yf), k, seam)
        np.testing.assert_allclose(
            _np(P), _np(jlat.prolong_seam(jnp.asarray(Xc), grid_f, k, jseam)),
            rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            _np(R), _np(jlat.restrict_seam(jnp.asarray(Yf), k, jseam)),
            rtol=1e-12, atol=1e-14)
        assert float(P[:, seam.s + 1, :seam.slit_lo].abs().max()) == 0.0
        lhs, rhs = float(torch.sum(P * _t(Yf))), float(torch.sum(_t(Xc) * R))
        assert abs(lhs - rhs) <= 1e-12 * (abs(lhs) + 1)
    P_embed = jgalerkin.embedding_matrices(2)
    jacC = lattice.coarsen_seam(slit["jac"][True], _t(P_embed), seam)
    jjacC = jlat.coarsen_seam(slit["jjac"][True], jnp.asarray(P_embed),
                              jseam)
    np.testing.assert_allclose(_np(jacC), _np(jjacC), rtol=1e-12,
                               atol=1e-12 * float(jacC.abs().max()))
    assert float(jacC[:, :, sc_.s].abs().max()) == 0.0
    # the injection of the active-set masks
    A = rng.uniform(size=(1,) + grid_f) < 0.3
    np.testing.assert_array_equal(
        _np(lattice._seam_inject_down(torch.as_tensor(A), seam)),
        _np(jlat._seam_inject_down(jnp.asarray(A), jseam)))


def _f32_close(a, b, what):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-4 * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("sharp", [False, True], ids=["gershgorin",
                                                      "lanczos"])
@pytest.mark.parametrize("which", ["u", "p"])
def test_prepare_levels_match_jax(slit, which, sharp):
    """(e), on the chain cast from the (split-free) f64 matrices."""
    hier, jhier = slit["hier"], slit["jhier"]
    jjac64 = slit["jjac"][False]
    jacs = lattice._prepare32_from64(_t(jjac64), hier.P_embed,
                                     n_levels=hier.n_levels, seam=hier.seam)
    jjacs = jlat._prepare32_from64(jjac64, jhier.P_embed,
                                   n_levels=jhier.n_levels, seam=jhier.seam)
    for a, b in zip(jacs, jjacs):
        _f32_close(a, b, "f32 chain")
    rng = slit["rng"]
    nv = slit["mesh"].n_vertices
    active = rng.uniform(size=nv) < 0.1
    act_L = lattice._active_lattice(torch.as_tensor(active), hier.vert_pos,
                                    hier.grid)
    levels, (cho, scale), _ = lattice._prepare_levels(
        jacs, hier.dir_u, hier.dir_p, act_L, grid=hier.grid, which=which,
        dim=2, sharp=sharp, seam=hier.seam)
    jlevels, (jcho, jscale), _ = jlat._prepare_levels(
        jjacs, jhier.dir_u, jhier.dir_p, jhier.vert_pos, jnp.asarray(active),
        grid=jhier.grid, which=which, dim=2, sharp=sharp, seam=jhier.seam)
    for lv, jlv in zip(levels, jlevels):
        np.testing.assert_array_equal(_np(lv.free), _np(jlv.free))
        _f32_close(lv.Dinv, jlv.Dinv, "Dinv")
        _f32_close(lv.lam, jlv.lam, "lambda")
    # JAX's factor is upper (cho_factor), the port's lower
    _f32_close(cho.T, np.triu(_np(jcho)), "coarse factor")
    _f32_close(scale, jscale, "coarse scale")
    k, lo, hi = lattice._blk(which, 2)
    R0 = np.where(_np(levels[-1].free),
                  rng.standard_normal((k,) + hier.grid), 0.0).astype(
                      np.float32)
    Z = lattice.make_vcycle(levels, lo, hi, k, (cho, scale),
                            seam=hier.seam)(_t(R0))
    jZ = jlat.make_vcycle(jlevels, lo, hi, k, coarse_factor=(jcho, jscale),
                          seam=jhier.seam)(jnp.asarray(R0))
    _f32_close(Z, jZ, "V-cycle")
    assert float(Z[:, hier.seam.s + 1, :hier.seam.slit_lo].abs().max()) == 0
