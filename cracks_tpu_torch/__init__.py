"""cracks_tpu_torch — the PyTorch/CUDA port of cracks_tpu.

The same phase-field fracture system (quasi-monolithic displacement /
phase-field formulation, primal-dual active-set Newton, lattice GMG
preconditioned mixed-precision CG), written on torch tensors for one
NVIDIA Hopper card.  The JAX package ``cracks_tpu`` stays beside it as
the reference every slice of this port is held against.

This package never imports jax, nor any file of ``cracks_tpu``: it
keeps its own copies of the numpy-only host modules (``config``,
``expressions``, ``meshio``, ``mesh`` with the native key core under
``native/``, ``fem``, ``problems``, ``statistics``, ``profiling``), and
builds whatever it compiles into its own ``build/`` directory.

The device is never chosen silently: ``Simulation``/``System`` take an
explicit ``device`` and create every tensor on it, and every tensor has
an explicit dtype (the package does not touch torch's default dtype).
"""

import torch as _torch

# Full-precision float32 products on the card.  The Galerkin RAP
# coarsening (solvers/lattice.coarsen) contracts the f32 element
# matrices with the embedding matrices once per level; at reduced
# precision (TF32 keeps ~10 mantissa bits) six successive RAPs were
# measured in the JAX package (bf16 passes on the TPU) to make the
# coarse operator indefinite and NaN the coarse Cholesky.  matmul's
# default is already False; cuDNN's default is True, so both are set.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
