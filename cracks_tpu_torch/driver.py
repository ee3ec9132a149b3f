"""Time-stepping driver (torch).

Port of ``cracks_tpu/driver.py`` for the slice this package covers:
the Sneddon active-set load-stepping loop on uniform lattices and on
hanging-node meshes, with local pre-refinement, the Sneddon
refinement-cycle countdown at stationarity (TCV, crack opening, phase-
field L2 error, then refine and restart from initial values), the
statistics table, VTU output and checkpoint/resume.  The Newton
systems go through the dense direct solve, the lattice GMG
mixed-precision CG or the stored-element-matrix Jacobi CG
(`solvers.newton._solve`).  Configurations outside that slice raise
NotImplementedError naming their ROADMAP item before any work starts;
nothing is skipped silently.
"""

from __future__ import annotations

import os
import time as walltime
from dataclasses import dataclass

import numpy as np
import torch

from . import checkpoint, kelly, qoi
from . import config, fem, meshio, mesh as hmesh, problems
from . import profiling, statistics
from .ops import physics
from .ops.constraints import (Constraints, hanging_interpolate_p,
                              hanging_interpolate_u, make_constraints)
from .ops.scatter import CellScatter, cell_scatter
from .output import PvdWriter, write_vtu
from .parallel.sharding import make_shard_mesh
from .solvers import lattice, lattice_newton, newton
from .solvers.newton import NoConvergence


@dataclass
class SolutionState:
    u: torch.Tensor
    phi: torch.Tensor
    u_old: torch.Tensor
    phi_old: torch.Tensor
    phi_oold: torch.Tensor
    last_log: object = None
    active_mask: object = None  # PDAS active set of the last solve (numpy)


def resolve_device(device) -> torch.device:
    """The explicit device of a run; a CUDA device without a card
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda requested but torch.cuda is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_supported(p) -> None:
    """Raise NotImplementedError for every configured feature outside
    the ported slice, naming its ROADMAP item."""
    unsupported = [
        (p.test_case != "sneddon",
         f"test case {p.test_case!r}: only Sneddon is ported; the others "
         "need the predictor-corrector redo loop with the spectral split "
         "(ROADMAP A1, A4) or the seam lattice (A9)"),
        (p.outer_solver != "active set",
         "penalized monolithic newton_iteration: ROADMAP A4"),
        (p.decompose_stress_matrix > 0 or p.decompose_stress_rhs > 0,
         "spectral stress split: ROADMAP A1"),
        (p.n_devices > 1 and p.dof_sharding != "lattice",
         f"n_devices={p.n_devices} with replicated DoF vectors (the GSPMD "
         "cell-axis mode): ROADMAP A11b; dof_sharding=lattice runs D "
         "shards on one device"),
        (p.mesh_dcn > 1, "a multi-host device mesh (mesh_dcn > 1): "
         "ROADMAP A11b"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(what)


class System:
    """Everything bound to one mesh epoch on one device: geometry
    tables, constraints, material fields, the lattice bundle, the shard
    mesh of the lattice-layout Newton, and the physics scalars
    (refreshed per solve context)."""

    def __init__(self, params, mesh, *, device):
        self.params = params
        self.mesh = mesh
        self.dim = mesh.dim
        self.device = torch.device(device)
        lam, mu = problems.cell_lame_fields(params, mesh, None)
        self.lam_cells = lam
        self.mu_cells = mu
        self.dtype = (torch.float64 if params.dtype == "float64"
                      else torch.float32)
        self._core = physics.build_cell_core(mesh, lam, mu,
                                             device=self.device)
        self.ca = physics.cell_arrays_from_core(self._core, self.dtype)
        self.mixed_precision = (params.mixed_precision_cg
                                and self.dtype == torch.float64)
        t = fem.element_tables(mesh.dim)
        self.diag_mass = torch.as_tensor(
            fem.lumped_mass_diag(mesh.cell_coords, mesh.cell2vert,
                                 mesh.n_vertices, t),
            dtype=self.dtype, device=self.device)
        mask_u, _, mask_p, _ = problems.dirichlet_conditions(
            params, mesh, 0.0, initial_step=False)
        self._con = make_constraints(mesh, mask_u, mask_p, dtype=self.dtype,
                                     device=self.device)
        # f32 cell arrays of the mixed-precision assembled solve and the
        # scatter tables of the stored-matrix operator, built at first
        # use
        self._ca32 = None
        self._cell_scatter = None
        # lattice bundle (attached by Simulation.setup_system); the
        # split lattice solve builds its f32 chain by casting the f64
        # element matrices, so no f32 raster cell arrays are kept
        self.lattice_hierarchy = None
        self._lattice_lay = None
        self._lattice_ca64 = None
        # operator caches of lattice.solve_lattice_lat
        self._split_jac_cache = None
        self._split_levels_cache = None
        # dof_sharding = lattice (set by Simulation.setup_system): the
        # lattice-layout Newton, and with n_devices = D > 1 its D row
        # slabs, all on this System's one device
        self.use_lattice_state = False
        self.shard_mesh = (make_shard_mesh([self.device] * params.n_devices)
                           if params.n_devices > 1 else None)
        # energy Lame fields on the device (qoi.energy_tcv_device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.lam_mu_dev = (torch.as_tensor(lam, **f64),
                           torch.as_tensor(mu, **f64))
        # context (set by the driver before each nonlinear solve)
        self.scalars: physics.Scalars = None
        self.with_split = False
        self.constant_k = 0.0
        self.alpha_eps = 0.0

    @property
    def ca32(self):
        """f32 cell arrays of the mixed-precision stored-matrix solve
        (None when mixed precision is off)."""
        if not self.mixed_precision:
            return None
        if self._ca32 is None:
            self._ca32 = physics.cell_arrays_from_core(self._core,
                                                       torch.float32)
        return self._ca32

    @property
    def cell_scatter(self) -> CellScatter:
        """Scatter tables of the cell gather maps (shared by `ca` and
        `ca32`)."""
        if self._cell_scatter is None:
            self._cell_scatter = cell_scatter(
                self.ca, self.mesh.n_vertices * self.dim,
                self.mesh.n_vertices)
        return self._cell_scatter

    @property
    def lattice_ca64(self):
        """Lazily built f64 raster-ordered cell arrays: the source of
        the exact stored element matrices of the lattice solve."""
        if self._lattice_ca64 is None and self._lattice_lay is not None:
            self._lattice_ca64 = physics.cell_arrays_from_core(
                self._core, torch.float64, perm=self._lattice_lay.cell_perm)
        return self._lattice_ca64

    @property
    def lat_gyp(self) -> int:
        """Padded leading-grid-axis extent of lattice-layout vectors:
        ceil(G0/D)*D with a shard mesh, G0 without."""
        g0 = self.lattice_hierarchy.grid[0]
        return g0 if self.shard_mesh is None else self.shard_mesh.padded(g0)

    def constraints(self, time: float) -> Constraints:
        # masks are time-independent and the Newton-update constraints
        # homogeneous, so one object serves all times
        return self._con

    def apply_initial_bc(self, u, phi, time: float):
        """set_initial_bc (cracks.cc:2699-2707): write the inhomogeneous
        boundary values into the (flat) solution."""
        mask_u, vals_u, mask_p, vals_p = problems.dirichlet_conditions(
            self.params, self.mesh, time, initial_step=True)
        dev = self.device
        u = torch.where(torch.as_tensor(mask_u.reshape(-1), device=dev),
                        torch.as_tensor(vals_u.reshape(-1), dtype=u.dtype,
                                        device=dev), u)
        phi = torch.where(torch.as_tensor(mask_p, device=dev),
                          torch.as_tensor(vals_p, dtype=phi.dtype,
                                          device=dev), phi)
        return u, phi

    def set_context(self, *, time, timestep, old_timestep, old_old_timestep,
                    use_old_timestep_pf, timestep_number):
        p = self.params
        gamma = p.effective_gamma_penal
        theta = (old_timestep + old_old_timestep) / old_old_timestep
        self.scalars = physics.make_scalars(
            pressure=p.pressure(time=time), constant_k=self.constant_k,
            alpha_eps=self.alpha_eps, G_c=p.G_c,
            gamma_dt=gamma / timestep, theta=theta,
            use_old_pf=1.0 if use_old_timestep_pf else 0.0,
            decompose_rhs=p.decompose_stress_rhs, dtype=self.dtype,
            device=self.device)
        self.with_split = (self.dim == 2 and p.decompose_stress_matrix > 0
                           and timestep_number > 0)


class Simulation:
    """The driver object (FracturePhaseFieldProblem analogue) on one
    explicit device."""

    def __init__(self, params, *, device, verbose: bool = True):
        check_supported(params)
        self.p = params
        self.device = resolve_device(device)
        self.verbose = verbose
        self.statistics = statistics.Statistics()
        self.timer = profiling.Timer()
        # setup_mesh (cracks.cc:1194-1303) for Sneddon, the only case
        # check_supported admits: 10 root subdivisions per axis
        # (cracks.cc:1207-1212), in 2d or 3d
        dim = params.dimension
        self.coarse = meshio.rect_mesh([-10] * dim, [10] * dim, [10] * dim)
        self.forest = hmesh.Forest(self.coarse)
        self.forest.refine_global(params.n_global_pre_refine)
        self.mesh = self.forest.extract()
        self.sys: System = None
        self.min_cell_diameter = 0.0
        self.constant_k = 0.0
        self.alpha_eps = 0.0
        self.time = 0.0
        self.timestep = params.timestep_size
        self.timestep_number = 0
        self.old_timestep = self.timestep
        self.old_old_timestep = self.timestep
        self.use_old_timestep_pf = False
        self.step_cuts = 0   # time-step cuts after a failed Newton solve
        self.output_counter = -1
        # the Sneddon refinement-cycle countdown; set by run(), or by
        # checkpoint.load_checkpoint for a resumed run
        self.refinement_cycle = None
        self.refinement_cycles_left = None
        self._balance_checked = False
        self.pvd = None
        if params.output_dir:
            os.makedirs(params.output_dir, exist_ok=True)
            with open(os.path.join(params.output_dir, "parameters.prm"),
                      "w") as f:
                f.write(config.dump_parameters(params))
            self.pvd = PvdWriter(params.output_dir)

    def log(self, *args):
        if self.verbose:
            print(*args)

    def setup_system(self):
        """A new System for the current mesh (one per mesh epoch).  The
        old epoch's System, with its operator caches, is dropped before
        the new one's tensors are built, so a run holds one epoch at a
        time.  The lattice hierarchy is built where the JAX package
        builds it (cracks_tpu/driver.py:303-337): gmg +
        assembled_matvec + mixed precision on a uniform tensor
        lattice."""
        p = self.p
        self.sys = None
        self.sys = System(p, self.mesh, device=self.device)
        self.sys.constant_k = self.constant_k
        self.sys.alpha_eps = self.alpha_eps
        lay = hier = None
        if (p.preconditioner == "gmg" and p.assembled_matvec
                and self.sys.mixed_precision):
            lay = lattice.detect_tensor_grid(self.mesh)
        if lay is not None:
            def dirichlet_fn(m):
                mu_, _, mp_, _ = problems.dirichlet_conditions(
                    p, m, 0.0, initial_step=False)
                return mu_, mp_

            hier = lattice.build_lattice_hierarchy(
                self.mesh, lay, dirichlet_fn, device=self.device)
        if hier is not None:
            self.sys.lattice_hierarchy = hier
            self.sys._lattice_lay = lay
        # the lattice-layout Newton (cracks_tpu/driver.py:361-397); the
        # JAX package runs it with no device mesh at n_devices = 1 too
        self.sys.use_lattice_state = (p.dof_sharding == "lattice"
                                      and hier is not None)
        if self.sys.use_lattice_state:
            mesh = self.sys.shard_mesh
            self.log(f"DoF sharding = lattice: D = "
                     f"{1 if mesh is None else mesh.n_shards} row slabs "
                     f"of the {lay.grid[0]}-row leading grid axis, padded "
                     f"to {self.sys.lat_gyp} rows, on {self.device}")
        elif p.dof_sharding == "lattice":
            if self.sys.shard_mesh is not None:
                raise NotImplementedError(
                    "dof_sharding=lattice with n_devices > 1 and no "
                    "lattice hierarchy needs the owned+ghost halo pool, "
                    "which is not ported: ROADMAP A11b")
            self.log("DoF sharding = lattice requested but unavailable "
                     "(no lattice hierarchy on this mesh); running the "
                     "replicated Newton")
        self.log(f"\nDoFs: {self.mesh.n_vertices * self.mesh.dim} solid + "
                 f"{self.mesh.n_vertices} phase = {self.mesh.n_dofs}")

    def determine_mesh_dependent_parameters(self):
        """cracks.cc:3820-3892 (Sneddon: h = the minimal cell
        diameter)."""
        p = self.p
        h = self.mesh.min_cell_diameter
        self.min_cell_diameter = h
        self.constant_k = p.k_reg(h)
        self.alpha_eps = p.eps_reg(h)
        if self.sys is not None:
            self.sys.constant_k = self.constant_k
            self.sys.alpha_eps = self.alpha_eps

    # ------------------------------------------------------------------
    # refinement
    # ------------------------------------------------------------------
    def _refine_flags(self, state: SolutionState) -> np.ndarray:
        """Strategy dispatch (cracks.cc:3902-4103)."""
        p = self.p
        mesh = self.mesh
        flags = np.zeros(mesh.n_cells, dtype=bool)
        strat = p.ref_strategy
        phi = state.phi.cpu().numpy()

        def box_flag(x0, x1, y0, y1):
            vc = mesh.cell_coords
            inside = ((vc[..., 0] >= x0) & (vc[..., 0] <= x1)
                      & (vc[..., 1] >= y0) & (vc[..., 1] <= y1))
            return inside.any(axis=1)

        def below_value():
            pf_cell = phi[mesh.cell2vert]
            return (pf_cell < p.value_phase_field_for_refinement).any(axis=1)

        if strat == "fixed preref sneddon":
            flags = box_flag(-2.5, 2.5, -1.25, 1.25)
        elif strat == "fixed preref miehe tension":
            flags = box_flag(0.0, 0.6, 0.45, 0.55)
        elif strat == "fixed preref miehe shear":
            flags = box_flag(0.0, 0.6, 0.0, 0.55)
        elif strat in ("fixed preref multiple homo",
                       "fixed preref multiple het"):
            # the reference declares these names but implements no
            # flagging for them (cracks.cc:3902-4103): no-op
            pass
        elif strat == "phase field":
            flags = below_value()
        elif strat == "phase field three point top":
            flags = below_value() | (mesh.cell_coords[..., 1]
                                     >= 1.75).any(axis=1)
        elif strat == "global":
            flags[:] = True
        elif strat == "mix":
            flags = below_value()
            eta = self._kelly_estimator(state)
            eta[flags] = 0.0
            n_refine = int(0.3 * mesh.n_cells)
            if n_refine > 0:
                thresh = np.partition(eta, -n_refine)[-n_refine]
                flags |= (eta >= thresh) & (eta > 0)
        else:
            raise NotImplementedError(strat)
        # the level cap of the other test cases (cracks.cc:4107-4116)
        # does not apply to Sneddon, the only case check_supported admits
        return flags

    def _kelly_estimator(self, state: SolutionState) -> np.ndarray:
        """Kelly face-jump error indicator on the displacement components
        (cracks.cc:4070-4083, kelly.py)."""
        return kelly.kelly_estimate(self.mesh, state.u.cpu().numpy())

    def refine_mesh(self, state: SolutionState) -> bool:
        """refine_mesh (cracks.cc:3895-4163): flag, balance, execute,
        transfer {solution, old, old_old}, re-setup.  Returns whether
        the mesh changed."""
        with self.timer.section("Refine mesh"):
            changed = self._refine_and_transfer(state)
        if changed:
            with self.timer.section("Setup system"):
                self.setup_system()
            self.determine_mesh_dependent_parameters()
        return changed

    def _refine_and_transfer(self, state: SolutionState) -> bool:
        """Flag, and where any cell is flagged refine the forest and
        move the five solution vectors onto the new mesh."""
        flags = self._refine_flags(state)
        if not flags.any():
            # the forest is 2:1-balanced after every refine_and_transfer,
            # and balancing an all-False flag vector must be a fixed
            # point; checked once per mesh epoch
            if not self._balance_checked:
                if self.forest.balance_flags(flags).any():
                    raise RuntimeError("forest not 2:1-balanced on entry "
                                       "to refine_mesh")
                self._balance_checked = True
            return False
        dim = self.mesh.dim
        host = lambda x: x.cpu().numpy()
        fields = [host(state.u).reshape(-1, dim), host(state.phi),
                  host(state.u_old).reshape(-1, dim), host(state.phi_old),
                  host(state.phi_oold)]
        new_mesh, new_fields, nref = self.forest.refine_and_transfer(
            flags, self.mesh, fields)
        if nref == 0:
            return False
        self.mesh = new_mesh
        self._balance_checked = False
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                                        dtype=torch.float64,
                                        device=self.device)
        (state.u, state.phi, state.u_old, state.phi_old,
         state.phi_oold) = (dev(f) for f in new_fields)
        return True

    # ------------------------------------------------------------------
    def interpolate_initial_values(self, state: SolutionState):
        u0, phi0 = problems.initial_values(self.p, self.mesh,
                                           self.min_cell_diameter)
        f64 = dict(dtype=torch.float64, device=self.device)
        state.u = torch.as_tensor(u0.reshape(-1), **f64)
        state.phi = torch.as_tensor(phi0, **f64)

    def project_back_phase_field(self, state: SolutionState):
        state.phi = state.phi.clamp(0.0, 1.0)

    def output_results(self, state: SolutionState):
        """One VTU per call plus the PVD/VisIt records
        (cracks.cc:3142-3258), with the Sneddon exact phase field, the
        active set of the last solve and the cell level and owner."""
        if self.pvd is None or not self.p.write_vtu:
            return
        self.output_counter += 1
        name = f"{self.p.output_filename}{self.output_counter:05d}.vtu"
        point_data = {"displacement": self._u_mat(state),
                      "phasefield": state.phi.cpu().numpy(),
                      "exact_phi": qoi.sneddon_exact_phi(
                          self.mesh.vert_coords, self.alpha_eps)}
        if (state.active_mask is not None
                and len(state.active_mask) == self.mesh.n_vertices):
            point_data["active_set"] = np.asarray(state.active_mask,
                                                  dtype=float)
        n_c = self.mesh.n_cells
        cell_data = {"level": self.mesh.cell_level.astype(float),
                     "subdomain": (np.arange(n_c) * self.p.n_devices
                                   // max(n_c, 1)).astype(float)}
        write_vtu(os.path.join(self.p.output_dir, name), self.mesh,
                  point_data, cell_data)
        self.pvd.add(self.time, name)

    def run(self, resume_state: SolutionState | None = None
            ) -> SolutionState:
        """The timestep loop (cracks.cc:4166-4581) for the active-set
        solver.

        With `resume_state` (from checkpoint.load_checkpoint, which has
        restored the forest, the System, the time-stepping fields and
        the refinement countdown) pre-refinement and initial values are
        skipped and the loop continues from the checkpointed step."""
        p = self.p
        t_start = walltime.time()
        self.log(f"Cells:\t{self.mesh.n_cells}")
        if resume_state is None:
            with self.timer.section("Setup system"):
                self.setup_system()
            self.determine_mesh_dependent_parameters()
            n_v = self.mesh.n_vertices
            f64 = dict(dtype=torch.float64, device=self.device)
            zero_u = torch.zeros(n_v * self.mesh.dim, **f64)
            zero_p = torch.zeros(n_v, **f64)
            state = SolutionState(u=zero_u, phi=zero_p, u_old=zero_u,
                                  phi_old=zero_p, phi_oold=zero_p)
            # local pre-refinement (cracks.cc:4177-4211)
            for _ in range(p.n_local_pre_refine):
                self.log(f"Prerefinement step with h= "
                         f"{self.min_cell_diameter}")
                self.interpolate_initial_values(state)
                state.u_old = state.u
                state.phi_old = state.phi
                state.phi_oold = state.phi
                self.refine_mesh(state)
        else:
            state = resume_state

        # sanity checks mirroring the reference (cracks.cc:4216-4217)
        if not (self.alpha_eps >= self.min_cell_diameter):
            raise ValueError("You need to pick eps >= h")
        if not (self.constant_k < 1.0):
            raise ValueError("You need to pick K < 1")

        self.log(f"\nParameters\n==========\n"
                 f"h (min):           {self.min_cell_diameter}\n"
                 f"k:                 {self.constant_k}\n"
                 f"eps:               {self.alpha_eps}\n"
                 f"G_c:               {p.G_c}\n")

        if resume_state is None:
            with self.timer.section("Initial values"):
                self.interpolate_initial_values(state)
                self.output_results(state)
                self.project_back_phase_field(state)
            state.phi_old = state.phi
            state.phi_oold = state.phi
            state.u_old = state.u
            self.old_timestep = self.timestep
            self.old_old_timestep = self.timestep

        # the refinement-cycle countdown persists on the Simulation so
        # the checkpoint carries it (cracks_tpu/driver.py:637-643)
        if self.refinement_cycle is None:
            self.refinement_cycle = 0
        if self.refinement_cycles_left is None:
            self.refinement_cycles_left = p.n_refinement_cycles
        finishing_timestep_loop = 0.0
        # per-step solver effort (timestep_number, newton_its,
        # linear_its, active-set size) and wall clock
        # (timestep_number, n_dofs, seconds)
        self.solver_effort = []
        self.step_times = []
        if (resume_state is not None
                and self.timestep_number > p.max_no_timesteps):
            self.log("Checkpoint is already past Max No of timesteps")
            return state

        while True:
            step_t0 = walltime.time()
            if (self.timestep_number > p.switch_timestep
                    and p.switch_timestep > 0):
                self.timestep = p.timestep_size_2

            tmp_timestep = self.timestep
            self.old_old_timestep = self.old_timestep
            self.old_timestep = self.timestep

            state.phi_oold = state.phi_old
            state.phi_old = state.phi
            state.u_old = state.u

            self.log(f"\nTimestep {self.timestep_number}: {self.time} "
                     f"({self.timestep})   Cells: {self.mesh.n_cells}   "
                     f"DoFs: {self.mesh.n_dofs}\n")
            solve = (lattice_newton.newton_active_set_lattice
                     if self.sys.use_lattice_state
                     else newton.newton_active_set)
            self.time += self.timestep
            while True:
                self.use_old_timestep_pf = False
                try:
                    self._set_context()
                    solve(self.sys, state, self.time, verbose=self.verbose)
                    break
                except NoConvergence:
                    self.step_cuts += 1
                    self.log(f"Solver did not converge! Adjusting time "
                             f"step to {self.timestep / 10}")
                self.log("Taking old_timestep_pf")
                self.use_old_timestep_pf = True
                state.u = state.u_old
                state.phi = state.phi_old
                self.time -= self.timestep
                self.timestep /= 10.0
                self.time += self.timestep

            log = state.last_log
            self.solver_effort.append((self.timestep_number,
                                       log.newton_steps,
                                       log.linear_iterations,
                                       log.active_set_size))

            self.project_back_phase_field(state)
            con = self.sys.constraints(self.time)
            state.u = hanging_interpolate_u(state.u, con)
            state.phi = hanging_interpolate_p(state.phi, con)
            self.timestep = tmp_timestep

            # ---- statistics (cracks.cc:4436-4459) ----
            st = self.statistics
            st.add_value("Timestep No", int(self.timestep_number))
            st.add_value("Time", float(self.time))
            st.add_value("DoFs", int(self.mesh.n_dofs))
            st.add_value("minimum cell diameter", self.min_cell_diameter)
            st.set_scientific("minimum cell diameter", 8)

            bulk_d, crack_d, tcv_d = qoi.energy_tcv_device(
                state.u, state.phi, self.sys.ca, *self.sys.lam_mu_dev,
                self.constant_k, self.alpha_eps, p.G_c, dim=self.mesh.dim)
            bulk, crack = float(bulk_d), float(crack_d)
            self.log(f"No {self.timestep_number} time {self.time} "
                     f"bulk energy: {bulk} crack energy: {crack}")
            st.add_value("Bulk Energy", bulk)
            st.set_scientific("Bulk Energy", 8)
            st.add_value("Crack Energy", crack)
            st.set_scientific("Crack Energy", 8)
            self.output_results(state)
            if p.output_dir:
                st.write(os.path.join(p.output_dir, "statistics"))

            finishing_timestep_loop = float(qoi.linf_diff_device(
                state.u, state.u_old, state.phi, state.phi_old))
            self.log(f"Timestep difference linfty: {finishing_timestep_loop}")

            self.timer.wall["Time step loop"] += walltime.time() - step_t0
            self.timer.calls["Time step loop"] += 1
            self.step_times.append((self.timestep_number, self.mesh.n_dofs,
                                    walltime.time() - step_t0))
            self.timestep_number += 1

            # ---- Sneddon stationarity (cracks.cc:4483-4560) ----
            if finishing_timestep_loop < 1e-5:
                tcv = float(tcv_d)
                ref = qoi.tcv_exact(self.mesh.dim, p.pressure(time=self.time),
                                    p.poisson_ratio_nu)
                self.log(f"TCV: value= {tcv} exact= {ref} "
                         f"error= {abs(tcv - ref)}")
                st.add_value("TCV", tcv)
                st.set_scientific("TCV", 8)
                self._write_cod_array(state)
                self._write_cod_profile(state)
                l2err = qoi.sneddon_phi_l2_error(
                    self.mesh, state.phi.cpu().numpy(), self.alpha_eps)
                self.log(f"phi_L2_error: {l2err} h: {self.min_cell_diameter}")
                st.add_value("phi_L2_error", l2err)
                st.set_scientific("phi_L2_error", 8)

                if self.refinement_cycles_left == 0:
                    break
                self.refinement_cycles_left -= 1
                self.log(f"\n==================\nRefinement cycle "
                         f"{self.refinement_cycle}\n------------------")
                self.refine_mesh(state)
                self.refinement_cycle += 1
                self.interpolate_initial_values(state)

            # one rolling restartable snapshot, taken after the
            # stationarity block so it carries any refinement this step
            # triggered and the remaining countdown
            if (p.checkpoint_every > 0 and p.output_dir
                    and self.timestep_number % p.checkpoint_every == 0):
                checkpoint.save_checkpoint(
                    os.path.join(p.output_dir, "checkpoint.npz"), self,
                    state)

            if self.timestep_number > p.max_no_timesteps:
                break

        self.log(f"\nFinishing time step loop: {finishing_timestep_loop}")
        if self.verbose:
            print(self.timer.summary())
            if self.device.type == "cuda":
                print(f"peak device memory: "
                      f"{torch.cuda.max_memory_allocated(self.device)} B")
        self.log(f"Total wall time: {walltime.time() - t_start:.2f}s")
        return state

    def _set_context(self):
        self.sys.set_context(
            time=self.time, timestep=self.timestep,
            old_timestep=self.old_timestep,
            old_old_timestep=self.old_old_timestep,
            use_old_timestep_pf=self.use_old_timestep_pf,
            timestep_number=self.timestep_number)

    def _u_mat(self, state) -> np.ndarray:
        return state.u.cpu().numpy().reshape(-1, self.mesh.dim)

    def _write_cod_array(self, state: SolutionState):
        """compute_cod_array (cracks.cc:3339-3449): the 75-bucket COD
        profile against the exact Sneddon opening 1.92e-3*sqrt(1-x^2),
        written to cod-NN.txt ("x value exact" per line), with the
        profile's L2 error and |COD(0) - 3.84e-4| printed in the
        reference's format (cracks.cc:3427-3436).  2d, with an output
        directory only."""
        if not self.p.output_dir or self.mesh.dim != 2:
            return
        u = self._u_mat(state)
        phi = state.phi.cpu().numpy()
        xs, vals, exact = qoi.compute_cod_array(self.mesh, u, phi)
        middle = qoi.compute_cod(self.mesh, u, phi, 0.0)
        path = os.path.join(self.p.output_dir,
                            f"cod-{self.timestep_number:02d}.txt")
        self.log(f"writing {os.path.basename(path)}")
        with open(path, "w") as f:
            for x, v, e in zip(xs, vals, exact):
                f.write(f"{x} {v} {e}\n")
        error = float(np.sqrt(np.sum((vals - exact) ** 2)))
        err_middle = abs(middle - 3.84e-4)
        self.log(f"ERROR: {error} alpha_eps: {self.alpha_eps} "
                 f"k: {self.constant_k} hmin: {self.min_cell_diameter} "
                 f"errmiddle: {err_middle} dofs: {self.mesh.n_dofs}")

    def _write_cod_profile(self, state: SolutionState):
        """compute_functional_values (cracks.cc:3704-3725): the COD at
        the 769 lines x in [-1.5, 1.5] (qoi.compute_cod_sweep), written
        to cod-NNb.txt where a face lies on the line."""
        if not self.p.output_dir or self.mesh.dim != 2:
            return
        N = 16 * 16
        xs = -1.5 + np.arange(3 * N + 1) * (1.0 / N)
        vals = qoi.compute_cod_sweep(self.mesh, self._u_mat(state),
                                     state.phi.cpu().numpy(), xs)
        path = os.path.join(self.p.output_dir,
                            f"cod-{self.timestep_number:02d}b.txt")
        with open(path, "w") as f:
            for x, v in zip(xs, vals):
                if v > -1e100:
                    f.write(f"{x} {v}\n")


def run_prm(path_or_text: str, *, device, **overrides):
    """CLI-style entry: run a .prm configuration end to end on
    `device`.  With `Resume from` set, the run continues from that
    checkpoint instead of initial values."""
    p = config.load_parameters(path_or_text, **overrides)
    if p.resume_from:
        sim, state = checkpoint.load_checkpoint(p.resume_from, p,
                                                device=device)
        return sim, sim.run(state)
    sim = Simulation(p, device=device)
    state = sim.run()
    return sim, state
