"""The PyTorch port imports nothing of jax and nothing of the JAX
package (not even its numpy-only modules: the port keeps its own
copies), builds its native forest core inside its own tree, and its
stencil wrapper uses the plain version only for CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "cracks_tpu_torch", "cracks_tpu_torch.interop",
    "cracks_tpu_torch.kernels", "cracks_tpu_torch.expressions",
    "cracks_tpu_torch.config", "cracks_tpu_torch.meshio",
    "cracks_tpu_torch.mesh", "cracks_tpu_torch.native",
    "cracks_tpu_torch.fem", "cracks_tpu_torch.problems",
    "cracks_tpu_torch.statistics", "cracks_tpu_torch.profiling",
    "cracks_tpu_torch.kelly", "cracks_tpu_torch.output",
    "cracks_tpu_torch.checkpoint",
    "cracks_tpu_torch.ops.physics", "cracks_tpu_torch.ops.constraints",
    "cracks_tpu_torch.ops.stencil", "cracks_tpu_torch.ops.scatter",
    "cracks_tpu_torch.parallel", "cracks_tpu_torch.parallel.sharding",
    "cracks_tpu_torch.solvers.galerkin", "cracks_tpu_torch.solvers.multigrid",
    "cracks_tpu_torch.solvers.lattice", "cracks_tpu_torch.solvers.newton",
    "cracks_tpu_torch.solvers.linear", "cracks_tpu_torch.solvers.assembled",
    "cracks_tpu_torch.solvers.lattice_newton",
    "cracks_tpu_torch.qoi", "cracks_tpu_torch.driver",
    "cracks_tpu_torch.__main__",
]


def test_port_never_imports_jax_or_the_jax_package():
    """In a fresh interpreter: import every module of the port and build
    a 3d forest (which loads the native key core); then no module may be
    a jax module or live under cracks_tpu/, and the native library must
    sit in the port's build directory."""
    jax_pkg = os.path.join(REPO, "cracks_tpu") + os.sep
    code = (
        "import importlib, os, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from cracks_tpu_torch import mesh, meshio, native\n"
        "f = mesh.Forest(meshio.rect_mesh([-1] * 3, [1] * 3, [2] * 3))\n"
        "f.refine_global(1)\n"
        "f.extract()\n"
        "files = {n: os.path.abspath(getattr(m, '__file__', None) or '')\n"
        "         for n, m in list(sys.modules.items())}\n"
        f"bad = sorted(n for n, p in files.items() if p.startswith("
        f"{jax_pkg!r}))\n"
        "bad += sorted(n for n in files if n.startswith('jax'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "print(native._SO)\n"
        "assert native._SO.startswith(os.path.join("
        f"{REPO!r}, 'cracks_tpu_torch', 'build') + os.sep)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_stencil_cpu_tensor_uses_plain_version():
    from cracks_tpu_torch.ops import stencil
    rng = np.random.default_rng(0)
    cases = [((12, 12, 6, 7), (2, 7, 8), (0, 8, 0, 8, 2, 2)),
             ((32, 32, 3, 4, 5), (3, 4, 5, 6), (0, 24, 0, 24, 3, 3))]
    for jshape, xshape, args in cases:
        jac = torch.as_tensor(rng.normal(size=jshape))
        X = torch.as_tensor(rng.normal(size=xshape))
        y = stencil.stencil_matvec(jac, X, *args)
        ref = stencil.stencil_matvec_reference(jac, X, *args)
        torch.testing.assert_close(y, ref, rtol=0, atol=0)
    assert stencil.stencil_matvec2d.launches == 0
    assert stencil.stencil_matvec3d.launches == 0
