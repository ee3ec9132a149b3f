"""Tests of the PyTorch port that need an NVIDIA GPU (marked `cuda`;
they skip elsewhere).  This file imports no jax, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA stencil kernels (2d and 3d) are held against their plain
PyTorch version on the card, at small non-square lattices, for every
block the lattice solve uses and both dtypes (f32: rtol 1e-5,
atol 1e-4 * max|Y|, the bounds of tests/test_pallas_stencil.py; f64:
rtol 1e-12, atol 1e-11 * max|Y|).  The 2d square blocks are also held
bit for bit against the sharded kernel at D = 1, on cell grids whose
rows take the phase-field kernel's 16-byte J loads (36 cells), its
8-byte (f32, 10 cells) or single-value loads (37 cells, or a J that
starts 4 or 8 bytes past a 16-byte boundary), whose vertex rows span
several of its 64-item CTAs (1100 cells: 276 items of 4 vertices in
f32) or whose CTAs span several rows (the others), and whose items do
not fill the last CTA; the phase-field block also at the main path's
640 x 640 cells.  The f64 3d products (the streaming
kernel of csrc/lattice_stencil3d_stream.cuh) are held against the plain
version for all four (k_in, k_out) pairs on cell grids with odd rows
(8-byte cp.async copies) and even rows (TMA boxes), rows cut into tiles
(more than 256 vertices), row counts not a multiple of the tile's and a
J whose first value is not 16-byte aligned, and the square blocks
against the sharded kernel at D = 1 bit for bit.  The row-slab sharded kernels (one
launch for all D shards) equal the unsharded kernel bit for bit, for D
in {1, 2, 3, 4, 8} (on D = 8 the last shard owns only pad rows), and
the plain version within the same tolerances.  The main path at refine
3 on the card,
replicated and with dof_sharding = lattice on 4 shards, agrees with
the CPU run (plain versions) to rel 1e-7 in the energies, and so does
the seam lattice (miehe_shear_2.prm at refine 3, 3 steps, with equal
Newton counts; its conjugated products equal the plain ones).  The dense
direct solve and the stored-element-matrix block CG on the first Newton
system of the Sneddon 2d golden (params/tests/sneddon_2d_1.prm, a
hanging-node mesh) agree between the card and the CPU (direct: rel
1e-10; CG: iteration counts within 2, updates within rel 1e-8), and
repeat bit for bit on the card (the deterministic scatter).  The
element build gives the same matrices (rel 1e-13) in one vmapped pass
of all its tangents as in passes of one.  On the dense systems of the first load
steps of the three-point golden and the shipped Miehe shear file, the
card's refined LU solve (solvers/linear.py) has a smaller backward
error than the unrefined one and lies no farther from the host's LAPACK
solution.  On `hetero_3d_1` the Galerkin GMG's f32 V-cycle and one pass
of its split solve agree between the card and the CPU (V-cycle rtol
1e-5 / atol 1e-4 of its largest value; the pass's update rel 1e-5, its
iterations within one) and repeat bit for bit, and two card runs of the
f64 Galerkin block CG are bit-equal and equal the CPU run to rel
1e-8.  The matrix-free operator (`assembled_matvec = False`, the Jacobi
CG in f64 and with mixed precision, its iterations replayed from CUDA
graphs) on Sneddon 2d refine 2 repeats bit for bit on the card and
equals the CPU run to rel 1e-8 with equal Newton counts."""

import os

import numpy as np
import pytest
import torch

from cracks_tpu_torch.ops import stencil

BLOCKS = [(0, 8, 0, 8, 2, 2), (8, 12, 8, 12, 1, 1), (8, 12, 0, 8, 2, 1)]
# 2d cell grids (GCY, GCX[, "unaligned": J one value past its buffer's
# start])
GRIDS2 = [(40, 36), (40, 37), (10, 10), (3, 1100), (9, 36, "unaligned")]
BLOCKS3 = [(0, 24, 0, 24, 3, 3), (24, 32, 24, 32, 1, 1),
           (24, 32, 0, 24, 3, 1)]
# the f64 streaming kernel's cell grids: odd rows (8-byte copies), even
# rows (TMA boxes), rows of more than 256 vertices cut into tiles,
# even and odd; 13, 10, 5 and 6 vertex rows leave a partial last tile
# at 2 or 3 rows a tile
GRIDS3_F64 = [(9, 12, 37), (7, 9, 38), (2, 4, 300), (3, 5, 301)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _jac_on(values, dtype, device, unaligned=False):
    """values as a contiguous J on the device; `unaligned`: one value past
    the start of its buffer."""
    if not unaligned:
        return torch.as_tensor(values, dtype=dtype, device=device)
    buf = torch.empty(values.size + 1, dtype=dtype, device=device)
    jac = buf[1:].view(values.shape)
    jac.copy_(torch.as_tensor(values))
    return jac


def _check_2d_product(jac, X, block, dtype):
    """One 2d product on the card: one launch (and one of the phase-field
    kernel for k = 1), within tolerance of the plain version, and for a
    square block bit for bit equal to the sharded kernel at D = 1."""
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    lo_r, hi_r, lo_c, hi_c, k_in, k_out = block
    kernel = stencil.stencil_matvec2d
    before = (kernel.launches, kernel.phi_launches)
    y = stencil.stencil_matvec(jac, X, *block)
    phi = int(k_in == k_out == 1)
    assert (kernel.launches, kernel.phi_launches) == (before[0] + 1,
                                                      before[1] + phi)
    ref = stencil.stencil_matvec_reference(jac, X, *block)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-11)
    torch.testing.assert_close(y, ref, rtol=rtol,
                               atol=atol * float(ref.abs().max()))
    if (lo_r, k_in) == (lo_c, k_out):
        mesh = make_shard_mesh([jac.device])
        JP = stencil.pad_jac_sharded(jac, lo_r, hi_r, lo_c, hi_c, mesh)
        assert torch.equal(y, stencil.stencil_matvec_sharded(JP, X, k_in,
                                                             mesh))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", GRIDS2,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", BLOCKS)
def test_kernel_matches_plain_version(cuda, dtype, block, cells):
    k_in = block[4]
    rng = np.random.default_rng(2)
    gcy, gcx = cells[:2]
    jac = _jac_on(rng.normal(size=(12, 12, gcy, gcx)), dtype, cuda,
                  unaligned=len(cells) > 2)
    if len(cells) > 2:
        assert jac.data_ptr() % 16 == jac.element_size()
    X = torch.as_tensor(rng.normal(size=(k_in, gcy + 1, gcx + 1)),
                        dtype=dtype, device=cuda)
    _check_2d_product(jac, X, block, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_phi_kernel_at_main_path_shape(cuda, dtype):
    """The phase-field block at the 2d main path's finest level, 640 x
    640 cells."""
    rng = np.random.default_rng(6)
    jac = torch.as_tensor(rng.standard_normal((12, 12, 640, 640),
                                              dtype=np.float32),
                          device=cuda).to(dtype)
    X = torch.as_tensor(rng.standard_normal((1, 641, 641)), dtype=dtype,
                        device=cuda)
    _check_2d_product(jac, X, BLOCKS[1], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", BLOCKS3)
def test_kernel3d_matches_plain_version(cuda, dtype, block):
    lo_r, hi_r, lo_c, hi_c, k_in, k_out = block
    rng = np.random.default_rng(3)
    jac = torch.as_tensor(rng.normal(size=(32, 32, 9, 12, 37)), dtype=dtype,
                          device=cuda)
    X = torch.as_tensor(rng.normal(size=(k_in, 10, 13, 38)), dtype=dtype,
                        device=cuda)
    before = stencil.stencil_matvec3d.launches
    y = stencil.stencil_matvec(jac, X, *block)
    assert stencil.stencil_matvec3d.launches == before + 1
    ref = stencil.stencil_matvec_reference(jac, X, *block)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-11)
    torch.testing.assert_close(y, ref, rtol=rtol,
                               atol=atol * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", GRIDS3_F64 + [(5, 6, 38, "unaligned")],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("block", BLOCKS3 + [(0, 24, 24, 32, 1, 3)])
def test_kernel3d_f64_stream_matches_plain_version(cuda, cells, block):
    """The f64 3d products against the plain version; the square blocks
    also bit for bit against the sharded kernel at D = 1.  "unaligned":
    J starts 8 bytes past a 16-byte boundary, so an even row takes the
    8-byte copies."""
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    lo_r, hi_r, lo_c, hi_c, k_in, k_out = block
    rng = np.random.default_rng(5)
    cells, unaligned = tuple(cells[:3]), len(cells) > 3
    jac = _jac_on(rng.normal(size=(32, 32) + cells), torch.float64, cuda,
                  unaligned)
    if unaligned:
        assert jac.data_ptr() % 16 == 8
    X = torch.as_tensor(rng.normal(size=(k_in,) + tuple(c + 1 for c in cells)),
                        device=cuda)
    before = (stencil.stencil_matvec3d.launches,
              stencil.stencil_matvec3d.f64_launches)
    y = stencil.stencil_matvec(jac, X, *block)
    assert (stencil.stencil_matvec3d.launches,
            stencil.stencil_matvec3d.f64_launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref = stencil.stencil_matvec_reference(jac, X, *block)
    torch.testing.assert_close(y, ref, rtol=1e-12,
                               atol=1e-11 * float(ref.abs().max()))
    if (lo_r, k_in) == (lo_c, k_out):
        mesh = make_shard_mesh([cuda])
        JP = stencil.pad_jac_sharded(jac, lo_r, hi_r, lo_c, hi_c, mesh)
        assert torch.equal(y, stencil.stencil_matvec_sharded(JP, X, k_in,
                                                             mesh))


@pytest.mark.cuda
def test_cuda_tensor_never_takes_plain_version(cuda):
    """A CUDA call the kernel cannot take raises; it does not fall back
    to the plain version."""
    jac = torch.zeros((12, 12, 4, 4), dtype=torch.float32, device=cuda)
    X = torch.zeros((2, 5, 6), dtype=torch.float32, device=cuda)
    jac3 = torch.zeros((32, 32, 2, 3, 4), dtype=torch.float32, device=cuda)
    X3 = torch.zeros((3, 3, 4, 5), dtype=torch.float32, device=cuda)
    before = (stencil.stencil_matvec2d.launches,
              stencil.stencil_matvec3d.launches)
    with pytest.raises(ValueError):
        stencil.stencil_matvec(jac, X, 0, 8, 0, 8, 2, 2)
    with pytest.raises(ValueError):
        stencil.stencil_matvec(jac3, X3, 0, 24, 0, 24, 2, 2)
    with pytest.raises(TypeError):
        stencil.stencil_matvec(jac3, X3.double(), 0, 24, 0, 24, 3, 3)
    assert (stencil.stencil_matvec2d.launches,
            stencil.stencil_matvec3d.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_wrapper_matches_unsharded_kernel(cuda, dim, D, dtype):
    """One launch per product, bit for bit equal to the unsharded kernel,
    within tolerance of the plain version.  41 rows on D = 8: the last
    shard owns rows 42-47, all pad; 10 planes on D = 8: shards 5-7."""
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    rng = np.random.default_rng(4)
    if dim == 2:
        jshape, grid = (12, 12, 40, 36), (41, 37)
        blocks = [(2, 0, 8), (1, 8, 12)]
    else:
        jshape, grid = (32, 32, 9, 12, 37), (10, 13, 38)
        blocks = [(3, 0, 24), (1, 24, 32)]
    jac = torch.as_tensor(rng.normal(size=jshape), dtype=dtype, device=cuda)
    mesh = make_shard_mesh([cuda] * D)
    for k, lo, hi in blocks:
        X = torch.as_tensor(rng.normal(size=(k,) + grid), dtype=dtype,
                            device=cuda)
        JP = stencil.pad_jac_sharded(jac, lo, hi, lo, hi, mesh)
        before = stencil.stencil_matvec_sharded.launches
        y = stencil.stencil_matvec_sharded(JP, X, k, mesh)
        assert stencil.stencil_matvec_sharded.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(y, stencil.stencil_matvec(jac, X, lo, hi, lo, hi,
                                                     k, k))
        rtol, atol = ((1e-5, 1e-4) if dtype == torch.float32
                      else (1e-12, 1e-11))
        for ref in (stencil.stencil_matvec_reference(jac, X, lo, hi, lo, hi,
                                                     k, k),
                    stencil.stencil_matvec_sharded_reference(JP, X, k, mesh)):
            torch.testing.assert_close(y, ref, rtol=rtol,
                                       atol=atol * float(ref.abs().max()))


@pytest.mark.cuda
def test_sharded_wrapper_rejects_mixed_devices(cuda):
    """A CPU carrier with a CUDA X, a non-contiguous X, a wrong k and a
    half-precision pair raise before any launch; none falls back to the
    plain version."""
    from cracks_tpu_torch.parallel.sharding import make_shard_mesh
    cpu = torch.device("cpu")
    mesh = make_shard_mesh([cuda] * 2)
    JP_cpu = stencil.pad_jac_sharded(torch.zeros((12, 12, 6, 7)), 0, 8, 0, 8,
                                     make_shard_mesh([cpu] * 2))
    JP = JP_cpu.to(cuda)
    X = torch.zeros((2, 7, 8), device=cuda)
    before = stencil.stencil_matvec_sharded.launches
    with pytest.raises(ValueError):
        stencil.stencil_matvec_sharded(JP_cpu, X, 2, mesh)
    with pytest.raises(ValueError):
        stencil.stencil_matvec_sharded(
            JP, X.transpose(1, 2).contiguous().transpose(1, 2), 2, mesh)
    with pytest.raises(ValueError):
        stencil.stencil_matvec_sharded(JP, X[:1].contiguous(), 1, mesh)
    with pytest.raises(TypeError):
        stencil.stencil_matvec_sharded(JP.half(), X.half(), 2, mesh)
    assert stencil.stencil_matvec_sharded.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("sharding", [dict(),
                                      dict(n_devices=4,
                                           dof_sharding="lattice")],
                         ids=["replicated", "lattice-4"])
def test_main_path_refine3_matches_cpu(cuda, sharding):
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch import config
    prm = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "params", "parameters_sneddon_2d.prm")
    p = config.load_parameters(
        prm, n_global_pre_refine=3, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
        linear_solver="cg", preconditioner="gmg", cg_rtol=1e-8,
        mixed_precision_cg=True, **sharding)
    energies = {}
    for dev in (cuda, torch.device("cpu")):
        before = stencil.stencil_matvec2d.launches
        sim = Simulation(p, device=dev, verbose=False)
        sim.run()
        launched = stencil.stencil_matvec2d.launches - before
        assert (launched > 0) == (dev.type == "cuda")
        d = sim.statistics.data
        energies[dev.type] = np.array(d["Bulk Energy"] + d["Crack Energy"])
    np.testing.assert_allclose(energies["cuda"], energies["cpu"], rtol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("sharding", [{}, dict(n_devices=4,
                                               dof_sharding="lattice")],
                         ids=["replicated", "sharded"])
def test_seam_lattice_refine3_matches_cpu(cuda, sharding):
    """params/tests/miehe_shear_2.prm at refine 3 under cg + gmg + mixed
    precision (the seam lattice), 3 steps: the card's conjugated kernel
    products give the CPU's statistics to rel 1e-7, equal Newton
    counts; the seam product at a small shape equals its plain
    version."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers.lattice import (Seam, seam_collect,
                                                  seam_spread)
    prm = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "params", "tests", "miehe_shear_2.prm")
    p = config.load_parameters(
        prm, max_no_timesteps=2, output_dir="", linear_solver="cg",
        preconditioner="gmg", mixed_precision_cg=True, cg_rtol=1e-8,
        **sharding)
    stats, newton = {}, {}
    for dev in (cuda, torch.device("cpu")):
        before = stencil.stencil_matvec2d.launches
        sim = Simulation(p, device=dev, verbose=False)
        sim.run()
        assert sim.sys.lattice_hierarchy.seam == Seam(8, 9)
        launched = stencil.stencil_matvec2d.launches - before
        assert (launched > 0) == (dev.type == "cuda")
        d = sim.statistics.data
        stats[dev.type] = np.array([d[c] for c in ("Bulk Energy",
                                                   "Crack Energy", "Load x")])
        newton[dev.type] = [e[1] for e in sim.solver_effort]
    np.testing.assert_allclose(stats["cuda"], stats["cpu"], rtol=1e-7)
    assert newton["cuda"] == newton["cpu"]
    seam = Seam(8, 9)
    rng = np.random.default_rng(0)
    jac = torch.tensor(rng.standard_normal((12, 12, 17, 16)), device=cuda)
    jac[:, :, seam.s] = 0.0
    X = torch.tensor(rng.standard_normal((2, 18, 17)), device=cuda)
    X[:, seam.s + 1, :seam.slit_lo] = 0.0
    for lo_r, hi_r, lo_c, hi_c, k_in, k_out in BLOCKS:
        args = (lo_r, hi_r, lo_c, hi_c, k_in, k_out)
        Xk = seam_spread(X[:k_in].contiguous(), seam)
        y = seam_collect(stencil.stencil_matvec(jac, Xk, *args), seam)
        y_ref = seam_collect(stencil.stencil_matvec_reference(jac, Xk, *args),
                             seam)
        np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                                   rtol=1e-12,
                                   atol=1e-11 * float(y_ref.abs().max()))
        assert float(y[:, seam.s + 1, :seam.slit_lo].abs().max()) == 0.0


def _golden_first_system(monkeypatch):
    """The arguments of the first dense direct solve of
    params/tests/sneddon_2d_1.prm, captured from a CPU run."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers import linear
    seen = []
    orig = linear.solve_direct

    def capture(*args, **kw):
        seen.append((args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(linear, "solve_direct", capture)
    prm = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "params", "tests", "sneddon_2d_1.prm")
    p = config.load_parameters(prm, max_no_timesteps=0, output_dir="")
    Simulation(p, device="cpu", verbose=False).run()
    return seen[0]


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if hasattr(x, "_fields"):         # a NamedTuple of tensors
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


@pytest.mark.cuda
def test_direct_solve_on_card_matches_cpu(cuda, monkeypatch):
    from cracks_tpu_torch.solvers import linear
    args, kw = _golden_first_system(monkeypatch)
    ref = linear.solve_direct(*args, **kw)
    cargs = _to(args, cuda)
    out = linear.solve_direct(*cargs, **kw)
    again = linear.solve_direct(*cargs, **kw)
    for a, b, c in zip(out[:2], ref[:2], again[:2]):
        assert a.device.type == cuda.type
        assert _rel(a, b) <= 1e-10
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_assembled_cg_on_card_matches_cpu(cuda, monkeypatch):
    from cracks_tpu_torch.ops.scatter import cell_scatter
    from cracks_tpu_torch.solvers import assembled
    args, kw = _golden_first_system(monkeypatch)
    u, phi, phi_old, phi_oold, ca, sc, con, active, rhs_u, rhs_p = args
    n_v = phi.shape[0]

    def solve(device):
        u_, p_, po, poo, ca_, sc_, con_, act, bu, bp = _to(args, device)
        jac = assembled.build_jacobians(u_, p_, po, poo, ca_, sc_,
                                        **kw)
        cs = cell_scatter(ca_, u_.shape[0], n_v)
        d_u, d_p = assembled.diagonals(jac, ca_, cs, dim=kw["dim"])
        return assembled.solve_cg_block(
            jac, ca_, con_, act, bu, bp, d_u, d_p, 1e-12, 1e-300, cs,
            dim=kw["dim"], maxiter=2000, stall_window=100)

    ref = solve(torch.device("cpu"))
    out = solve(cuda)
    again = solve(cuda)
    assert abs(out[2] - ref[2]) <= 2 and out[2] == again[2] > 0
    for a, b, c in zip(out[:2], ref[:2], again[:2]):
        assert _rel(a, b) <= 1e-8
        assert torch.equal(a, c)


def _seeded_element_inputs(reps, refine, device):
    """Per-cell arrays of a uniform 2d mesh over the Sneddon box (reps^2
    coarse cells refined `refine` times) and seeded u and phase fields,
    f64."""
    from cracks_tpu_torch import meshio, problems
    from cracks_tpu_torch.config import Parameters
    from cracks_tpu_torch.mesh import Forest
    from cracks_tpu_torch.ops import physics
    f = Forest(meshio.rect_mesh([-10, -10], [10, 10], [reps] * 2))
    f.refine_global(refine)
    mesh = f.extract()
    p = Parameters(test_case="sneddon", pressure_expr="1.0e-3", G_c=1.0,
                   poisson_ratio_nu=0.2, E_modulus=1.0)
    lam, mu = problems.cell_lame_fields(p, mesh, None)
    ca = physics.cell_arrays_from_core(
        physics.build_cell_core(mesh, lam, mu, device=device),
        torch.float64)
    rng = np.random.default_rng(7)
    n_v = mesh.n_vertices
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    fields = (t(rng.normal(size=n_v * 2) * 1e-2),
              *(t(rng.uniform(-0.2, 1.0, n_v)) for _ in range(3)))
    sc = physics.make_scalars(0.5, 1e-2, 0.7, 1.0, 3.0, 1.5, 0.0, 0.0,
                              dtype=torch.float64, device=device)
    return fields, ca, sc


@pytest.mark.cuda
@pytest.mark.parametrize("reps,refine", [(16, 0), (25, 3)],
                         ids=["256-cells", "40000-cells"])
def test_element_build_for_any_tangents_per_pass_on_card(
        cuda, monkeypatch, reps, refine):
    """The element build on the card with the split: one vmapped pass of
    all 12 one-hot tangents (the default below 2^18 / 12 cells) and
    passes of one (a mesh of 2^18 cells or more) give the same element
    matrices within rel 1e-13 (not bit for bit: the card's batched
    contractions may sum in another order)."""
    from cracks_tpu_torch.ops import physics
    (u, phi, phi_old, phi_oold), ca, sc = _seeded_element_inputs(
        reps, refine, cuda)
    build = lambda: physics.element_matrices(
        u, phi, phi_old, phi_oold, ca, sc, dim=2, with_split=True,
        monolithic=False)
    whole = build()
    n_c = whole.shape[-1]
    assert physics.JVP_BATCH_CELL_TANGENTS // n_c >= len(whole)
    monkeypatch.setattr(physics, "JVP_BATCH_CELL_TANGENTS", n_c)
    one = build()
    torch.testing.assert_close(one, whole, rtol=1e-13,
                               atol=1e-13 * float(whole.abs().max()))


def _backward_error(A, b, x):
    """The normwise backward error |b - A x| / (|A| |x| + |b|) in the
    infinity norm, on the host."""
    r = (b - A @ x).abs().max()
    return float(r / (A.abs().sum(dim=1).max() * x.abs().max()
                      + b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("prm,steps", [
    (("params", "tests", "threepoint_1.prm"), 1),
    (("params", "parameters_miehe_shear_adaptive.prm"), 1)],
    ids=["threepoint_1", "shipped_miehe_shear"])
def test_card_refinement_reduces_dense_solve_error(cuda, monkeypatch, prm,
                                                   steps):
    """On every dense Newton system of the first load steps of the
    three-point golden and the shipped Miehe shear file, as the card
    meets them: cuSOLVER's LU solve refined CARD_REFINEMENT_STEPS times
    has a smaller largest and median backward error than the unrefined
    solve, and its largest distance to the host's LAPACK solution is no
    larger.  (The median distance is not smaller on the Miehe systems:
    at ~2e-15 both solves sit at LAPACK's own rounding.)"""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch.solvers import linear
    systems = []
    reduced = linear._reduced_system

    def capture(*args, **kw):
        A_red, b, C = reduced(*args, **kw)
        systems.append((A_red.cpu(), b.cpu()))
        return A_red, b, C

    monkeypatch.setattr(linear, "_reduced_system", capture)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = config.load_parameters(os.path.join(root, *prm),
                               max_no_timesteps=steps, output_dir="")
    Simulation(p, device=cuda, verbose=False).run()
    assert systems
    eta, dist = {0: [], 1: []}, {0: [], 1: []}
    for A, b in systems:
        x_host = torch.linalg.solve(A, b)
        for k, n in ((0, 0), (1, linear.CARD_REFINEMENT_STEPS)):
            x = linear._lu_solve(A.to(cuda), b.to(cuda), n)[0].cpu()
            eta[k].append(_backward_error(A, b, x))
            dist[k].append(float((x - x_host).abs().max()
                                 / x_host.abs().max()))
    print(f"{len(systems)} systems of {A.shape[0]} DoFs or fewer; backward "
          f"error unrefined / refined: max {max(eta[0]):.3e} / "
          f"{max(eta[1]):.3e}, median {np.median(eta[0]):.3e} / "
          f"{np.median(eta[1]):.3e}; distance to LAPACK: max "
          f"{max(dist[0]):.3e} / {max(dist[1]):.3e}, median "
          f"{np.median(dist[0]):.3e} / {np.median(dist[1]):.3e}")
    assert max(eta[1]) < max(eta[0])
    assert np.median(eta[1]) < np.median(eta[0])
    assert max(dist[1]) <= max(dist[0])


HETERO_PRM = ("params", "tests", "hetero_3d_1.prm")


def _hetero_prerefined(device):
    """hetero_3d_1 (3d, bitmap material, 318 hanging vertices) after its
    local pre-refinement on `device`, with the solve context of its
    first step set."""
    from cracks_tpu_torch import config
    from cracks_tpu_torch.driver import Simulation, SolutionState
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = config.load_parameters(os.path.join(root, *HETERO_PRM),
                               output_dir="", linear_solver="cg",
                               preconditioner="gmg", mixed_precision_cg=True)
    sim = Simulation(p, device=device, verbose=False)
    sim.setup_system()
    sim.determine_mesh_dependent_parameters()
    n_v = sim.mesh.n_vertices
    f64 = dict(dtype=torch.float64, device=device)
    z, zp = torch.zeros(n_v * 3, **f64), torch.zeros(n_v, **f64)
    st = SolutionState(u=z, phi=zp, u_old=z, phi_old=zp, phi_oold=zp)
    for _ in range(p.n_local_pre_refine):
        sim.interpolate_initial_values(st)
        st.u_old, st.phi_old, st.phi_oold = st.u, st.phi, st.phi
        sim.refine_mesh(st)
    sim.time, sim.timestep_number = 0.01, 0
    sim._set_context()
    return sim


@pytest.mark.cuda
def test_galerkin_vcycle_and_split_pass_on_card_match_cpu(cuda):
    """The f32 Galerkin V-cycle and one pass of the split solve (the f32
    CG pass and the f64 jvp refinement) on hetero_3d_1, from the same
    seeded state, on the card and on the CPU: the V-cycle within rtol
    1e-5 / atol 1e-4 of its largest value, the pass's trial update within
    rel 1e-5 and its iteration count within one; the card repeats both
    bit for bit."""
    from cracks_tpu_torch.solvers import galerkin
    rng = np.random.default_rng(9)
    out = {}
    for dev in (torch.device("cpu"), cuda, cuda):
        sim = _hetero_prerefined(dev)
        n_v = sim.mesh.n_vertices
        rs = np.random.default_rng(9)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        phi = rs.uniform(0.2, 1.0, n_v)
        state = (t(rs.normal(scale=1e-3, size=n_v * 3)), t(phi),
                 t(np.minimum(1.0, phi + 0.05)),
                 t(np.minimum(1.0, phi + 0.05)))
        active = torch.as_tensor((rs.uniform(size=n_v) < 0.1)
                                 & ~sim.mesh.hanging_mask(), device=dev)
        con = sim.sys.constraints(0.0)
        jac32 = galerkin._g_jac32(sim.sys, *state, False)
        ops, _ = galerkin.build_level_ops(
            sim.sys.galerkin_hierarchy, jac32, sim.sys.galerkin_fine,
            active, dim=3)
        b = torch.as_tensor(rs.normal(size=n_v * 3), dtype=torch.float32,
                            device=dev)
        y = galerkin.make_vcycle(ops, dim=3, which="u")(b)
        op32, free, _, _, _ = galerkin._pieces(ops[-1], "u", 3)
        rhs = torch.where(free, t(rs.normal(size=n_v * 3)), 0.0)
        R0, scale, tol2 = galerkin._g_pass_setup(free, rhs, 1e-8,
                                                 t(1e-18))
        M32 = galerkin.make_vcycle(ops, dim=3, which="u")
        Xb, k = galerkin._g_cg_pass32(op32, M32, R0, tol2)
        x_try, _, rr_try, _ = galerkin._g_pass_apply(
            sim.sys, *state, con, active, Xb, scale, torch.zeros_like(rhs),
            rhs, "u", False)
        out.setdefault(dev.type, []).append(
            (y.cpu(), x_try.cpu(), int(k), float(rr_try)))
    (y_h, x_h, k_h, rr_h), = out["cpu"]
    (y_c, x_c, k_c, rr_c), again = out["cuda"]
    torch.testing.assert_close(y_c, y_h, rtol=1e-5,
                               atol=1e-4 * float(y_h.abs().max()))
    assert abs(k_c - k_h) <= 1 and k_c > 0
    assert _rel(x_c, x_h) <= 1e-5
    assert torch.equal(y_c, again[0]) and torch.equal(x_c, again[1])
    print(f"V-cycle max |card - cpu| / max |y| "
          f"{float((y_c - y_h).abs().max() / y_h.abs().max()):.3e}; pass "
          f"its {k_c} / {k_h}, rr {rr_c:.3e} / {rr_h:.3e}")


@pytest.mark.cuda
def test_hetero_3d_gmg_on_card_repeats_and_matches_cpu(cuda):
    """hetero_3d_1 under f64 cg + gmg (the Galerkin block CG), first
    step: two card runs are bit-equal, and equal the CPU port to rel
    1e-8 with equal Newton counts."""
    from cracks_tpu_torch.driver import run_prm
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for dev in ("cpu", cuda, cuda):
        sim, _ = run_prm(os.path.join(root, *HETERO_PRM), device=dev,
                         output_dir="", max_no_timesteps=0,
                         linear_solver="cg", preconditioner="gmg")
        assert sim.sys.galerkin_hierarchy is not None
        d = sim.statistics.data
        runs.append((np.array([d["Bulk Energy"], d["Crack Energy"]]),
                     [e[:3] for e in sim.solver_effort]))
    (e_h, eff_h), (e_c, eff_c), (e_c2, eff_c2) = runs
    assert np.array_equal(e_c, e_c2) and eff_c == eff_c2
    np.testing.assert_allclose(e_c, e_h, rtol=1e-8, atol=0)
    assert [e[1] for e in eff_c] == [e[1] for e in eff_h]


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(preconditioner="jacobi", mixed_precision_cg=False),
    dict(preconditioner="jacobi", mixed_precision_cg=True),
], ids=["jacobi-f64", "jacobi-mixed"])
def test_matrix_free_refine2_matches_cpu(cuda, over):
    """The matrix-free operator (assembled_matvec = False) on Sneddon 2d
    refine 2, two load steps: the card run (its CG iterations replayed
    from CUDA graphs) repeats bit for bit and equals the CPU run to rel
    1e-8 with equal Newton counts."""
    from cracks_tpu_torch.driver import Simulation
    from cracks_tpu_torch import config
    from cracks_tpu_torch.solvers import newton
    prm = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "params", "parameters_sneddon_2d.prm")
    p = config.load_parameters(
        prm, n_global_pre_refine=2, n_local_pre_refine=0,
        n_refinement_cycles=0, max_no_timesteps=1, output_dir="",
        linear_solver="cg", cg_rtol=1e-8, cg_maxiter=3000,
        assembled_matvec=False, **over)
    runs = []
    for dev in (torch.device("cpu"), cuda, cuda):
        sim = Simulation(p, device=dev, verbose=False)
        sim.run()
        assert newton.check_linear_solver(sim.sys) == "matrix-free"
        d = sim.statistics.data
        runs.append((np.array([d["Bulk Energy"], d["Crack Energy"]]),
                     [e[1:3] for e in sim.solver_effort]))
    (e_h, eff_h), (e_c, eff_c), (e_c2, eff_c2) = runs
    assert np.array_equal(e_c, e_c2) and eff_c == eff_c2
    np.testing.assert_allclose(e_c, e_h, rtol=1e-8, atol=0)
    assert [e[0] for e in eff_c] == [e[0] for e in eff_h]
