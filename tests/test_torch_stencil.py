"""The stencil matvec's plain PyTorch version against the JAX package,
in 2d and 3d: the Pallas kernels `_kernel`/`_kernel3d` in interpret
mode (f32, the bounds of tests/test_pallas_stencil.py: rtol 1e-5,
atol 1e-4) and the XLA slice formulation lattice.matvec_block (f64,
rtol 1e-12 — the same products summed in another order).  The CUDA
kernels themselves are held against the same plain version on the card
by chip_smoke.py and tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cracks_tpu.ops import pallas_stencil as ps
from cracks_tpu.solvers import lattice as jlat
from cracks_tpu_torch.ops import stencil

torch.set_num_threads(1)

GY, GX = 41, 37
CELLS3 = (3, 4, 5)     # a small non-cubic 3d cell grid


def _inputs(seed, k_in, dtype, cells=(GY - 1, GX - 1)):
    rng = np.random.default_rng(seed)
    ndl = 12 if len(cells) == 2 else 32
    jac = rng.normal(size=(ndl, ndl) + tuple(cells)).astype(dtype)
    X = rng.normal(size=(k_in,) + tuple(c + 1 for c in cells)).astype(dtype)
    return jac, X


@pytest.mark.parametrize("k,lo,hi", [(2, 0, 8), (1, 8, 12)])
def test_reference_matches_pallas_interpret(k, lo, hi):
    jac, X = _inputs(0, k, np.float32)
    y_pl = ps.stencil_matvec(jnp.asarray(jac[lo:hi, lo:hi]), jnp.asarray(X),
                             k=k, ty=16, tx=16, interpret=True)
    y = stencil.stencil_matvec_reference(torch.as_tensor(jac),
                                         torch.as_tensor(X), lo, hi, lo, hi,
                                         k, k)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("lo_r,hi_r,lo_c,hi_c,k_in,k_out", [
    (0, 8, 0, 8, 2, 2),      # u block
    (8, 12, 8, 12, 1, 1),    # phase-field block
    (8, 12, 0, 8, 2, 1),     # J_pu coupling
    (0, 8, 8, 12, 1, 2),     # J_up coupling
])
def test_reference_matches_xla_matvec_block_f64(lo_r, hi_r, lo_c, hi_c,
                                                k_in, k_out):
    jac, X = _inputs(1, k_in, np.float64)
    ref = np.asarray(jlat.matvec_block(jnp.asarray(jac), jnp.asarray(X),
                                       lo_r, hi_r, lo_c, hi_c, k_in, k_out))
    y = stencil.stencil_matvec(torch.as_tensor(jac), torch.as_tensor(X),
                               lo_r, hi_r, lo_c, hi_c, k_in, k_out)
    assert tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("k,lo,hi", [(3, 0, 24), (1, 24, 32)])
def test_reference_matches_pallas3d_interpret(k, lo, hi):
    jac, X = _inputs(2, k, np.float32, CELLS3)
    y_pl = ps.stencil_matvec3d(jnp.asarray(jac[lo:hi, lo:hi]),
                               jnp.asarray(X), k=k, tz=4, ty=8, tx=16,
                               interpret=True)
    y = stencil.stencil_matvec_reference(torch.as_tensor(jac),
                                         torch.as_tensor(X), lo, hi, lo, hi,
                                         k, k)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("lo_r,hi_r,lo_c,hi_c,k_in,k_out", [
    (0, 24, 0, 24, 3, 3),      # u block
    (24, 32, 24, 32, 1, 1),    # phase-field block
    (24, 32, 0, 24, 3, 1),     # J_pu coupling
    (0, 24, 24, 32, 1, 3),     # J_up coupling
])
def test_reference3d_matches_xla_matvec_block_f64(lo_r, hi_r, lo_c, hi_c,
                                                  k_in, k_out):
    jac, X = _inputs(3, k_in, np.float64, CELLS3)
    ref = np.asarray(jlat.matvec_block(jnp.asarray(jac), jnp.asarray(X),
                                       lo_r, hi_r, lo_c, hi_c, k_in, k_out))
    y = stencil.stencil_matvec(torch.as_tensor(jac), torch.as_tensor(X),
                               lo_r, hi_r, lo_c, hi_c, k_in, k_out)
    assert tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_wrapper_rejects_bad_calls():
    jac = torch.zeros((12, 12, 4, 4), dtype=torch.float32)
    X = torch.zeros((2, 5, 5), dtype=torch.float32)
    bad = [
        (jac, X.double(), (0, 8, 0, 8, 2, 2)),          # mixed dtypes
        (jac, X[:, :4], (0, 8, 0, 8, 2, 2)),            # grid mismatch
        (jac, X, (0, 8, 0, 4, 2, 2)),                   # wrong block width
        (jac, X, (8, 16, 0, 8, 2, 2)),                  # rows out of range
        (jac.transpose(2, 3), X, (0, 8, 0, 8, 2, 2)),   # not contiguous
    ]
    jac3 = torch.zeros((32, 32, 3, 4, 5), dtype=torch.float64)
    X3 = torch.zeros((3, 4, 5, 6), dtype=torch.float64)
    bad += [
        (jac3, X3[:, :, :4], (0, 24, 0, 24, 3, 3)),     # grid mismatch
        (jac3, X3[:1], (0, 24, 0, 24, 3, 3)),           # k_in vs X
        (jac3, X3, (0, 24, 0, 24, 2, 2)),               # k not in {1, 3}
        (jac3, X3, (24, 48, 0, 24, 3, 3)),              # rows out of range
        (jac3[:, :, :2], X3[:, :3], (0, 24, 0, 24, 3, 3)),   # not contig.
        (jac3, X3.float(), (0, 24, 0, 24, 3, 3)),       # mixed dtypes
    ]
    for j, x, args in bad:
        with pytest.raises((ValueError, TypeError)):
            stencil._check(j, x, *args)
    stencil._check(jac3, X3, 0, 24, 0, 24, 3, 3)
    stencil._check(jac3, X3[:1].contiguous(), 24, 32, 24, 32, 1, 1)
    # the kernel wrappers take only CUDA tensors (checked before any
    # build), so a CPU tensor never reaches a kernel
    for fn, j, x, args in ((stencil.stencil_matvec2d, jac, X,
                            (0, 8, 0, 8, 2, 2)),
                           (stencil.stencil_matvec3d, jac3, X3,
                            (0, 24, 0, 24, 3, 3))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(j, x, *args)
    assert stencil.stencil_matvec2d.launches == 0
    assert stencil.stencil_matvec3d.launches == 0
