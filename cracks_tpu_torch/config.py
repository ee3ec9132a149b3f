"""Configuration system: deal.II-style .prm files and typed parameters.

Mirrors the reference's declarative parameter schema
(reference cracks.cc:1307-1405, ``declare_parameters``) and its runtime
resolution (cracks.cc:1411-1575, ``set_runtime_parameters``), including
expression-valued parameters: ``Pressure`` is a function of ``time`` and
``K reg`` / ``Eps reg`` are functions of the mesh size ``h``
(cracks.cc:1490-1491, 3876-3883).
"""

from __future__ import annotations

import dataclasses
import io
import os
from dataclasses import dataclass, field

from .expressions import Expression


# ---------------------------------------------------------------------------
# .prm text format
# ---------------------------------------------------------------------------

def _strip_comment(line: str) -> str:
    # '#' starts a comment anywhere in the line (deal.II ParameterHandler).
    pos = line.find("#")
    if pos >= 0:
        line = line[:pos]
    return line.strip()


def parse_prm(text_or_path: str) -> dict[str, dict[str, str]]:
    """Parse a .prm file (path or text) into {subsection: {name: value}}."""
    if "\n" not in text_or_path and os.path.exists(text_or_path):
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path

    sections: dict[str, dict[str, str]] = {}
    stack: list[str] = []
    for raw in io.StringIO(text):
        line = _strip_comment(raw)
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            stack.append(line[len("subsection"):].strip())
        elif low == "end":
            if not stack:
                raise ValueError("unbalanced 'end' in parameter file")
            stack.pop()
        elif low.startswith("set "):
            if "=" not in line:
                raise ValueError(f"malformed set line: {raw!r}")
            name, value = line[len("set "):].split("=", 1)
            key = "/".join(stack)
            sections.setdefault(key, {})[name.strip()] = value.strip()
        else:
            raise ValueError(f"cannot parse parameter line: {raw!r}")
    if stack:
        raise ValueError("unterminated subsection in parameter file")
    return sections


def write_prm(sections: dict[str, dict[str, str]]) -> str:
    """Render {subsection: {name: value}} back to .prm text."""
    out = []
    for sec in sorted(sections):
        out.append(f"subsection {sec}")
        for name in sorted(sections[sec]):
            out.append(f"  set {name} = {sections[sec][name]}")
        out.append("end")
        out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Typed parameters
# ---------------------------------------------------------------------------

OUTER_SOLVERS = ("active set", "simple monolithic")
TEST_CASES = (
    "sneddon",
    "miehe tension",
    "miehe shear",
    "multiple homo",
    "multiple het",
    "three point bending",
)
REF_STRATEGIES = (
    "phase field",
    "fixed preref sneddon",
    "fixed preref miehe tension",
    "fixed preref miehe shear",
    "fixed preref multiple homo",
    "fixed preref multiple het",
    "global",
    "mix",
    "phase field three point top",
)


@dataclass
class Parameters:
    """All runtime parameters, with the reference's defaults.

    Schema and defaults follow reference cracks.cc:1307-1405.
    """

    # --- Global parameters ---
    dimension: int = 2
    fe_degree: int = 1
    n_global_pre_refine: int = 1
    n_local_pre_refine: int = 0
    n_refinement_cycles: int = 0
    max_no_timesteps: int = 1
    timestep_size: float = 1.0
    timestep_size_2: float = 1.0
    switch_timestep: int = 0
    outer_solver: str = "active set"
    test_case: str = "sneddon"
    ref_strategy: str = "phase field"
    value_phase_field_for_refinement: float = 0.0
    output_dir: str = "output"
    output_filename: str = "solution_"

    # --- Problem dependent parameters (expressions kept as text) ---
    k_reg_expr: str = "1.0 * h"          # function of h
    eps_reg_expr: str = "1.0 * h"        # function of h
    gamma_penal: float = 0.0
    pressure_expr: str = "0.0"           # function of time
    G_c: float = 0.0
    poisson_ratio_nu: float = 0.0
    E_modulus: float = 0.0
    lame_mu: float = 0.0
    lame_lambda: float = 0.0

    # --- Solver parameters ---
    direct_solver: bool = False
    lower_bound_newton_residual: float = 1.0e-10
    max_no_newton_steps: int = 10
    upper_newton_rho: float = 0.999
    max_no_line_search_steps: int = 5
    line_search_damping: float = 0.5
    decompose_stress_rhs: float = 0.0
    decompose_stress_matrix: float = 0.0

    # --- cracks_tpu-specific extensions (not in the reference schema) ---
    # PDAS set-settled complementarity band, RELATIVE to the largest
    # active constraint force (the reference's active_set_tolarance is
    # the absolute-zero special case, cracks.cc:2860): a Newton
    # iteration whose status flips all carry |indicator| below this
    # band counts as a settled set.  Exact set fixity always
    # short-circuits first; the band only terminates the asymptotic
    # marginal-dof peel seen at 1M+ DoFs (solvers/newton.py).
    active_set_rel_tol: float = 1.0e-6
    # linear solver backend: "auto" | "direct" | "cg"
    linear_solver: str = "auto"
    # compute dtype for element kernels ("float64" for parity, "float32" fast)
    dtype: str = "float64"
    # CG relative tolerance (matrix-free path)
    cg_rtol: float = 1.0e-12
    cg_maxiter: int = 2000
    # CG steps per device call (bounded executions for flaky workers)
    cg_chunk: int = 100
    # solve the Newton UPDATE systems in float32 (inexact Newton with
    # iterative-refinement flavor): residuals/convergence stay float64,
    # the Krylov solve runs at TPU-native f32 speed
    mixed_precision_cg: bool = False
    # CG preconditioner: 'jacobi' or 'gmg' (geometric multigrid)
    preconditioner: str = 'jacobi'
    # Krylov operator: True = stored per-cell element Jacobians (built
    # once per Newton iteration; every CG iteration is a batched dense
    # matvec — solvers/assembled.py), False = re-derive the physics
    # Jacobian-vector product each iteration (round-1 behavior)
    assembled_matvec: bool = True
    # number of devices to shard element arrays over (1 = single chip)
    n_devices: int = 1
    # DCN (inter-host) axis extent of the device mesh: 1 = flat
    # single-host ("cells",) mesh; >1 = host-major ("dcn", "cells")
    # product mesh for multi-host slices (n_devices/mesh_dcn chips per
    # host) — the cell partition is identical, but XLA lowers
    # collectives hierarchically (parallel/sharding.make_device_mesh)
    mesh_dcn: int = 1
    # DoF vector distribution across the device mesh:
    #  "replicated" — element arrays sharded, DoF vectors whole on every
    #     chip (combine = full-size psum; exact, memory-bound at scale);
    #  "lattice"    — sharded-DoF production path: state in lattice
    #     layout, sharded in slabs along the leading grid axis; all
    #     inter-chip traffic is the one-row window halo (the reference's
    #     owned+ghost rows + compress(add), cracks.cc:1622-1628,
    #     2470-2475).  Requires the tensor-grid lattice fast path and
    #     the active-set outer solver; falls back to replicated
    #     otherwise.
    dof_sharding: str = "replicated"
    # write VTU visualization output every step
    write_vtu: bool = False
    # write <output_dir>/checkpoint.npz every N completed load steps
    # (0 = off; a new capability over the reference, SURVEY section 5)
    checkpoint_every: int = 0
    # resume a run from a checkpoint file instead of initial values
    resume_from: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        # The reference honors `Use Direct Inner Solver` as THE solver
        # selection (cracks.cc:2750-2758); map it onto the backend knob
        # unless the TPU extension chose a backend explicitly.
        if self.direct_solver and self.linear_solver == "auto":
            self.linear_solver = "direct"
        if self.outer_solver not in OUTER_SOLVERS:
            raise ValueError(f"unknown outer solver {self.outer_solver!r}")
        if self.test_case not in TEST_CASES:
            raise ValueError(f"unknown test case {self.test_case!r}")
        if self.ref_strategy not in REF_STRATEGIES:
            raise ValueError(f"unknown ref strategy {self.ref_strategy!r}")
        if self.dimension not in (2, 3):
            raise ValueError("Dimension must be 2 or 3")
        if self.dof_sharding not in ("replicated", "lattice"):
            raise ValueError(f"unknown DoF sharding {self.dof_sharding!r}")
        if self.mesh_dcn < 1 or self.n_devices % self.mesh_dcn:
            raise ValueError("Mesh DCN axis must divide Number of "
                             f"devices ({self.mesh_dcn} vs "
                             f"{self.n_devices})")

    # Derived material constants (reference cracks.cc:1500-1525).
    @property
    def derived_lame(self) -> tuple[float, float]:
        """(mu, lambda) — from E/nu for pressure-driven cases, from the
        explicit Lame parameters for the Miehe/three-point cases."""
        if self.test_case in ("sneddon", "multiple homo", "multiple het"):
            mu = self.E_modulus / (2.0 * (1.0 + self.poisson_ratio_nu))
            lam = (2.0 * self.poisson_ratio_nu * mu) / (1.0 - 2.0 * self.poisson_ratio_nu)
            return mu, lam
        return self.lame_mu, self.lame_lambda

    @property
    def pressure(self) -> Expression:
        return Expression(self.pressure_expr)

    def k_reg(self, h: float) -> float:
        return Expression(self.k_reg_expr)(h=h)

    def eps_reg(self, h: float) -> float:
        return Expression(self.eps_reg_expr)(h=h)

    @property
    def effective_gamma_penal(self) -> float:
        # gamma penalization forced to 0 in active-set mode (cracks.cc:1484-1487)
        if self.outer_solver == "active set":
            return 0.0
        return self.gamma_penal

    def replace(self, **kwargs) -> "Parameters":
        return dataclasses.replace(self, **kwargs)


# mapping: (subsection, prm entry name) -> (Parameters field, converter)
def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "yes", "1", "on")


_PRM_MAP = {
    ("Global parameters", "Dimension"): ("dimension", int),
    ("Global parameters", "FE degree"): ("fe_degree", int),
    ("Global parameters", "Global pre-refinement steps"): ("n_global_pre_refine", int),
    ("Global parameters", "Local pre-refinement steps"): ("n_local_pre_refine", int),
    ("Global parameters", "Adaptive refinement cycles"): ("n_refinement_cycles", int),
    ("Global parameters", "Max No of timesteps"): ("max_no_timesteps", int),
    ("Global parameters", "Timestep size"): ("timestep_size", float),
    ("Global parameters", "Timestep size to switch to"): ("timestep_size_2", float),
    ("Global parameters", "Switch timestep after steps"): ("switch_timestep", int),
    ("Global parameters", "outer solver"): ("outer_solver", str),
    ("Global parameters", "test case"): ("test_case", str),
    ("Global parameters", "ref strategy"): ("ref_strategy", str),
    ("Global parameters", "value phase field for refinement"):
        ("value_phase_field_for_refinement", float),
    ("Global parameters", "Output directory"): ("output_dir", str),
    ("Global parameters", "Output filename"): ("output_filename", str),
    ("Problem dependent parameters", "K reg"): ("k_reg_expr", str),
    ("Problem dependent parameters", "Eps reg"): ("eps_reg_expr", str),
    ("Problem dependent parameters", "Gamma penalization"): ("gamma_penal", float),
    ("Problem dependent parameters", "Pressure"): ("pressure_expr", str),
    ("Problem dependent parameters", "Fracture toughness G_c"): ("G_c", float),
    ("Problem dependent parameters", "Poisson ratio nu"): ("poisson_ratio_nu", float),
    ("Problem dependent parameters", "E modulus"): ("E_modulus", float),
    ("Problem dependent parameters", "Lame mu"): ("lame_mu", float),
    ("Problem dependent parameters", "Lame lambda"): ("lame_lambda", float),
    ("Solver parameters", "Use Direct Inner Solver"): ("direct_solver", _to_bool),
    ("Solver parameters", "Newton lower bound"): ("lower_bound_newton_residual", float),
    ("Solver parameters", "Newton maximum steps"): ("max_no_newton_steps", int),
    ("Solver parameters", "Upper Newton rho"): ("upper_newton_rho", float),
    ("Solver parameters", "Line search maximum steps"): ("max_no_line_search_steps", int),
    ("Solver parameters", "Line search damping"): ("line_search_damping", float),
    ("Solver parameters", "Decompose stress in rhs"): ("decompose_stress_rhs", float),
    ("Solver parameters", "Decompose stress in matrix"): ("decompose_stress_matrix", float),
    # cracks_tpu extensions (optional subsection)
    ("TPU parameters", "Linear solver"): ("linear_solver", str),
    ("TPU parameters", "Dtype"): ("dtype", str),
    ("TPU parameters", "CG relative tolerance"): ("cg_rtol", float),
    ("TPU parameters", "CG maximum iterations"): ("cg_maxiter", int),
    ("TPU parameters", "Preconditioner"): ("preconditioner", str),
    ("TPU parameters", "CG chunk"): ("cg_chunk", int),
    ("TPU parameters", "Mixed precision CG"): ("mixed_precision_cg", _to_bool),
    ("TPU parameters", "Number of devices"): ("n_devices", int),
    ("TPU parameters", "Mesh DCN axis"): ("mesh_dcn", int),
    ("TPU parameters", "Checkpoint every"): ("checkpoint_every", int),
    ("TPU parameters", "Resume from"): ("resume_from", str),
    ("TPU parameters", "DoF sharding"): ("dof_sharding", str),
    ("TPU parameters", "Write VTU"): ("write_vtu", _to_bool),
}


def load_parameters(text_or_path: str, **overrides) -> Parameters:
    """Read a .prm file (or raw text) into a Parameters dataclass."""
    sections = parse_prm(text_or_path)
    kwargs = {}
    for (sec, name), (fieldname, conv) in _PRM_MAP.items():
        if sec in sections and name in sections[sec]:
            kwargs[fieldname] = conv(sections[sec][name])
    # Warn about unrecognized entries (mirrors ParameterHandler's strictness
    # without aborting).
    known = {(sec, name) for (sec, name) in _PRM_MAP}
    for sec, entries in sections.items():
        for name in entries:
            if (sec, name) not in known:
                raise ValueError(f"unknown parameter '{name}' in subsection '{sec}'")
    kwargs.update(overrides)
    return Parameters(**kwargs)


def default_parameters() -> Parameters:
    return Parameters()


def dump_parameters(p: Parameters) -> str:
    """Render the fully-resolved parameters back to .prm text
    (the reference echoes parameters.prm into the output directory,
    cracks.cc:4623-4626)."""
    sections: dict[str, dict[str, str]] = {}
    for (sec, name), (fieldname, conv) in _PRM_MAP.items():
        value = getattr(p, fieldname)
        if conv is _to_bool:
            value = "true" if value else "false"
        sections.setdefault(sec, {})[name] = str(value)
    return write_prm(sections)
