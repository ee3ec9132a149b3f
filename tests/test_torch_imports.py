"""The PyTorch port never imports jax, and its stencil wrapper uses the
plain version only for CPU tensors."""

import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

PORT_MODULES = [
    "cracks_tpu_torch", "cracks_tpu_torch.host", "cracks_tpu_torch.interop",
    "cracks_tpu_torch.kernels", "cracks_tpu_torch.ops.physics",
    "cracks_tpu_torch.ops.constraints", "cracks_tpu_torch.ops.stencil",
    "cracks_tpu_torch.solvers.galerkin", "cracks_tpu_torch.solvers.multigrid",
    "cracks_tpu_torch.solvers.lattice", "cracks_tpu_torch.solvers.newton",
    "cracks_tpu_torch.qoi", "cracks_tpu_torch.driver",
    "cracks_tpu_torch.__main__",
]


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "             in ('jax', 'cracks_tpu'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_stencil_cpu_tensor_uses_plain_version():
    from cracks_tpu_torch.ops import stencil
    rng = np.random.default_rng(0)
    jac = torch.as_tensor(rng.normal(size=(12, 12, 6, 7)))
    X = torch.as_tensor(rng.normal(size=(2, 7, 8)))
    before = stencil.stencil_matvec.launches
    y = stencil.stencil_matvec(jac, X, 0, 8, 0, 8, 2, 2)
    y_ref = stencil.stencil_matvec_reference(jac, X, 0, 8, 0, 8, 2, 2)
    assert stencil.stencil_matvec.launches == before == 0
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
