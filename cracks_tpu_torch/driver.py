"""Time-stepping driver (torch).

Port of ``cracks_tpu/driver.py`` for the slice this package covers:
the active-set load-stepping loop on a uniform tensor lattice, solved
by the lattice GMG Newton path, with the Sneddon stationarity block
(TCV, phase-field L2 error) and the statistics table.  Configurations
outside that slice raise NotImplementedError naming their ROADMAP item
before any work starts; nothing is skipped silently.
"""

from __future__ import annotations

import os
import time as walltime
from dataclasses import dataclass

import torch

from . import qoi
from . import config, fem, meshio, mesh as hmesh, problems
from . import profiling, statistics
from .ops import physics
from .ops.constraints import (Constraints, hanging_interpolate_p,
                              hanging_interpolate_u, make_constraints)
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
         "need adaptive refinement (ROADMAP A5) or the seam lattice (A9)"),
        (p.outer_solver != "active set",
         "penalized monolithic newton_iteration: ROADMAP A4"),
        (p.decompose_stress_matrix > 0 or p.decompose_stress_rhs > 0,
         "spectral stress split: ROADMAP A1"),
        (p.n_local_pre_refine > 0 or p.n_refinement_cycles > 0,
         "mesh refinement (local pre-refinement, refinement cycles): "
         "ROADMAP A5"),
        (p.write_vtu, "VTU output: ROADMAP A5"),
        (p.checkpoint_every > 0 or bool(p.resume_from),
         "checkpoint/resume: ROADMAP A5"),
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
        # context (set by the driver before each nonlinear solve)
        self.scalars: physics.Scalars = None
        self.with_split = False
        self.constant_k = 0.0
        self.alpha_eps = 0.0

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
        if params.output_dir:
            os.makedirs(params.output_dir, exist_ok=True)
            with open(os.path.join(params.output_dir, "parameters.prm"),
                      "w") as f:
                f.write(config.dump_parameters(params))

    def log(self, *args):
        if self.verbose:
            print(*args)

    def setup_system(self):
        p = self.p
        self.sys = System(p, self.mesh, device=self.device)
        self.sys.constant_k = self.constant_k
        self.sys.alpha_eps = self.alpha_eps
        lay = lattice.detect_tensor_grid(self.mesh)
        hier = None
        if lay is not None:
            def dirichlet_fn(m):
                mu_, _, mp_, _ = problems.dirichlet_conditions(
                    p, m, 0.0, initial_step=False)
                return mu_, mp_

            hier = lattice.build_lattice_hierarchy(
                self.mesh, lay, dirichlet_fn, device=self.device)
        if hier is None:
            raise NotImplementedError(
                "the mesh is not a coarsenable uniform tensor lattice: "
                "slit (seam) lattices are ROADMAP A9, hanging-node and "
                "unstructured meshes need the Galerkin GMG (A10), and "
                "their sharded mode the owned+ghost halo pool (A11b)")
        self.sys.lattice_hierarchy = hier
        self.sys._lattice_lay = lay
        # the lattice-layout Newton (cracks_tpu/driver.py:361-364); the
        # JAX package runs it with no device mesh at n_devices = 1 too
        self.sys.use_lattice_state = p.dof_sharding == "lattice"
        if self.sys.use_lattice_state:
            mesh = self.sys.shard_mesh
            self.log(f"DoF sharding = lattice: D = "
                     f"{1 if mesh is None else mesh.n_shards} row slabs "
                     f"of the {lay.grid[0]}-row leading grid axis, padded "
                     f"to {self.sys.lat_gyp} rows, on {self.device}")
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

    def interpolate_initial_values(self, state: SolutionState):
        u0, phi0 = problems.initial_values(self.p, self.mesh,
                                           self.min_cell_diameter)
        f64 = dict(dtype=torch.float64, device=self.device)
        state.u = torch.as_tensor(u0.reshape(-1), **f64)
        state.phi = torch.as_tensor(phi0, **f64)

    def project_back_phase_field(self, state: SolutionState):
        state.phi = state.phi.clamp(0.0, 1.0)

    def run(self) -> SolutionState:
        """The timestep loop (cracks.cc:4166-4581) for the active-set
        solver on a fixed lattice."""
        p = self.p
        t_start = walltime.time()
        self.log(f"Cells:\t{self.mesh.n_cells}")
        with self.timer.section("Setup system"):
            self.setup_system()
        self.determine_mesh_dependent_parameters()

        n_v = self.mesh.n_vertices
        f64 = dict(dtype=torch.float64, device=self.device)
        zero_u = torch.zeros(n_v * self.mesh.dim, **f64)
        zero_p = torch.zeros(n_v, **f64)
        state = SolutionState(u=zero_u, phi=zero_p, u_old=zero_u,
                              phi_old=zero_p, phi_oold=zero_p)

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

        with self.timer.section("Initial values"):
            self.interpolate_initial_values(state)
            self.project_back_phase_field(state)
        state.phi_old = state.phi
        state.phi_oold = state.phi
        state.u_old = state.u
        self.old_timestep = self.timestep
        self.old_old_timestep = self.timestep

        finishing_timestep_loop = 0.0
        # per-step solver effort (timestep_number, newton_its,
        # linear_its, active-set size) and wall clock
        # (timestep_number, n_dofs, seconds)
        self.solver_effort = []
        self.step_times = []
        lam_e = torch.as_tensor(self.sys.lam_cells, **f64)
        mu_e = torch.as_tensor(self.sys.mu_cells, **f64)
        solve = (lattice_newton.newton_active_set_lattice
                 if self.sys.use_lattice_state
                 else newton.newton_active_set)

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
                state.u, state.phi, self.sys.ca, lam_e, mu_e,
                self.constant_k, self.alpha_eps, p.G_c, dim=self.mesh.dim)
            bulk, crack = float(bulk_d), float(crack_d)
            self.log(f"No {self.timestep_number} time {self.time} "
                     f"bulk energy: {bulk} crack energy: {crack}")
            st.add_value("Bulk Energy", bulk)
            st.set_scientific("Bulk Energy", 8)
            st.add_value("Crack Energy", crack)
            st.set_scientific("Crack Energy", 8)
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
                self.log("(crack-opening profiles cod-*.txt are not "
                         "written by this port yet: ROADMAP A5)")
                l2err = qoi.sneddon_phi_l2_error(
                    self.mesh, state.phi.cpu().numpy(), self.alpha_eps)
                self.log(f"phi_L2_error: {l2err} h: {self.min_cell_diameter}")
                st.add_value("phi_L2_error", l2err)
                st.set_scientific("phi_L2_error", 8)
                # no refinement cycles are configured (check_supported)
                break

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


def run_prm(path_or_text: str, *, device, **overrides):
    """CLI-style entry: run a .prm configuration end to end on
    `device`."""
    p = config.load_parameters(path_or_text, **overrides)
    sim = Simulation(p, device=device)
    state = sim.run()
    return sim, state
