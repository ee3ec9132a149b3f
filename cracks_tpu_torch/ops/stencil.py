"""The 2d lattice block-stencil matvec: hand-written CUDA kernel and its
plain PyTorch version.

For vertex (d, vy, vx) of a uniform 2d Q1 lattice with stored element
matrices J (R, C, GCY, GCX):

    Y[d,vy,vx] = sum_{a,b,e} J[lo_r + a*k_out + d, lo_c + b*k_in + e,
                               vy-oy_a, vx-ox_a]
                             * X[e, vy-oy_a+oy_b, vx-ox_a+ox_b]

over the 4 cell corners a, b (offset (oy, ox) = (a >> 1, a & 1)) and
the k_in input components e; cells outside the cell grid contribute
nothing.  Rows [lo_r, hi_r) and columns [lo_c, hi_c) of the local
element matrices select the block: the u block (k = 2), the
phase-field block (k = 1) or the rectangular J_pu coupling
(k_in = 2, k_out = 1).

`stencil_matvec` dispatches on the device of X: a CUDA tensor goes to
the kernel in ``csrc/lattice_stencil.cu`` (replacing the Pallas TPU
kernel ``cracks_tpu/ops/pallas_stencil.py::_kernel``) or raises; a CPU
tensor goes to `stencil_matvec_reference`, the slice formulation of
``cracks_tpu/solvers/lattice.py::matvec_block``.
"""

from __future__ import annotations

import torch

from .. import kernels

_OFFS = ((0, 0), (0, 1), (1, 0), (1, 1))   # corner a -> (oy, ox)


def stencil_matvec_reference(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Plain PyTorch version: gather the 4 shifted cell windows of X,
    one batched per-cell product with the J block, scatter-add the 4
    shifted windows back.  jac (R, C, GCY, GCX); X (k_in, GY, GX)
    -> (k_out, GY, GX)."""
    GY, GX = X.shape[1:]
    GCY, GCX = GY - 1, GX - 1
    Xe = torch.stack([X[:, oy:oy + GCY, ox:ox + GCX] for oy, ox in _OFFS])
    Xf = Xe.reshape(4 * k_in, GCY, GCX)
    Yf = torch.einsum("ijyx,jyx->iyx", jac[lo_r:hi_r, lo_c:hi_c], Xf)
    Ye = Yf.reshape(4, k_out, GCY, GCX)
    Y = torch.zeros((k_out, GY, GX), dtype=X.dtype, device=X.device)
    for a, (oy, ox) in enumerate(_OFFS):
        Y[:, oy:oy + GCY, ox:ox + GCX] += Ye[a]
    return Y


def _check(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    if jac.device != X.device:
        raise ValueError(f"jac on {jac.device}, X on {X.device}")
    if X.dtype not in (torch.float32, torch.float64) \
            or jac.dtype != X.dtype:
        raise TypeError(f"stencil_matvec takes f32 or f64 of one dtype, "
                        f"got jac {jac.dtype}, X {X.dtype}")
    if jac.dim() != 4 or X.dim() != 3:
        raise ValueError(f"need jac (R, C, GCY, GCX) and X (k, GY, GX), "
                         f"got {tuple(jac.shape)}, {tuple(X.shape)}")
    if not (jac.is_contiguous() and X.is_contiguous()):
        raise ValueError("stencil_matvec needs contiguous jac and X")
    R, C, GCY, GCX = jac.shape
    if (X.shape[1] - 1, X.shape[2] - 1) != (GCY, GCX):
        raise ValueError(f"cell grid {(GCY, GCX)} does not match vertex "
                         f"grid {tuple(X.shape[1:])}")
    if k_in not in (1, 2) or k_out not in (1, 2) or X.shape[0] != k_in:
        raise ValueError(f"k_in={k_in}, k_out={k_out}, X has "
                         f"{X.shape[0]} components")
    if not (0 <= lo_r and hi_r - lo_r == 4 * k_out and hi_r <= R
            and 0 <= lo_c and hi_c - lo_c == 4 * k_in and hi_c <= C):
        raise ValueError(f"block rows [{lo_r},{hi_r}) cols [{lo_c},{hi_c})"
                         f" does not fit jac {tuple(jac.shape)} with "
                         f"k_in={k_in}, k_out={k_out}")


def stencil_matvec(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out):
    """Y = J_block X on the lattice.  CUDA tensors launch the kernel
    (and count the launch in `stencil_matvec.launches`); CPU tensors use
    the plain version."""
    if X.device.type == "cpu":
        return stencil_matvec_reference(jac, X, lo_r, hi_r, lo_c, hi_c,
                                        k_in, k_out)
    if X.device.type != "cuda":
        raise ValueError(f"stencil_matvec: unsupported device {X.device}")
    _check(jac, X, lo_r, hi_r, lo_c, hi_c, k_in, k_out)
    lib = kernels.lattice_stencil()
    fn = (lib.lattice_stencil_f32 if X.dtype == torch.float32
          else lib.lattice_stencil_f64)
    R, C, GCY, GCX = jac.shape
    Y = torch.empty((k_out,) + tuple(X.shape[1:]), dtype=X.dtype,
                    device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(jac.data_ptr(), X.data_ptr(), Y.data_ptr(), R, C, GCY,
                 GCX, lo_r, lo_c, k_in, k_out, stream)
    if err != 0:
        raise RuntimeError(f"lattice_stencil launch failed: CUDA error "
                           f"{err}")
    stencil_matvec.launches += 1
    return Y


stencil_matvec.launches = 0
