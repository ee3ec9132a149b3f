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
the CPU run (plain versions) to rel 1e-7 in the energies.  The dense
direct solve and the stored-element-matrix block CG on the first Newton
system of the Sneddon 2d golden (params/tests/sneddon_2d_1.prm, a
hanging-node mesh) agree between the card and the CPU (direct: rel
1e-10; CG: iteration counts within 2, updates within rel 1e-8), and
repeat bit for bit on the card (the deterministic scatter)."""

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
