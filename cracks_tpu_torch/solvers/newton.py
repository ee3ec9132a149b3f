"""Primal-dual active set semismooth Newton and the penalized
monolithic Newton iteration (torch).

Port of ``newton_active_set`` and ``newton_iteration`` from
``cracks_tpu/solvers/newton.py`` (reference cracks.cc:2780-2994 and
2997-3107): host control flow around device tensor work.  The active
set is a boolean mask over phase-field vertices; convergence logic,
cycle detection and the backtracking line search follow the reference
step for step.  The linear solve is routed
as in the JAX package: the dense direct solve, the lattice GMG
mixed-precision CG, the Galerkin GMG on the stored element matrices
(f64 block CG, or the mixed-precision split solve), the geometric GMG
of the matrix-free operator, the stored-element-matrix Jacobi CG, or
the matrix-free Jacobi CG (`assembled_matvec = False`: every Krylov
iteration applies the Jacobian through one jvp of the residual).  Every
linear operator is built with the System's `monolithic` flag (the
clamped phase field of the penalized mode).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..ops import physics
from ..ops.constraints import (condense_residual, expand_update,
                               hanging_interpolate_p, hanging_interpolate_u,
                               hanging_transpose_p, residual_linfty,
                               residual_norm)
from . import assembled, galerkin, lattice, linear


class NoConvergence(Exception):
    """Raised when Newton fails; the driver catches it and cuts the time
    step (cracks.cc:4333-4336)."""


@dataclass
class NewtonLog:
    newton_steps: int = 0
    linear_iterations: int = 0
    active_set_size: int = 0
    # the largest single block-CG count of the solve (the halo pool's
    # Jacobi CG, 0 elsewhere): the one reading that shows whether a
    # block stopped at its fixed 2000-iteration cap without raising
    # (chip_smoke.py phase 19 prints it per epoch)
    max_block_iterations: int = 0
    lines: list = field(default_factory=list)

    def print_line(self, *cols, verbose=True):
        line = "\t".join(str(c) for c in cols)
        self.lines.append(line)
        if verbose:
            print(line)


def krylov_path(sys) -> str:
    """The iterative solve of a configuration, in the JAX package's
    order (cracks_tpu/solvers/newton.py:70-148): "lattice" (the lattice
    GMG mixed-precision CG; its hierarchy exists only under gmg +
    assembled_matvec + mixed precision on a uniform lattice), "galerkin"
    (the Galerkin GMG on the stored element matrices: gmg +
    assembled_matvec without the lattice hierarchy; the f64 block CG, or
    with mixed precision the split solve), "geometric" (the geometric
    GMG of the matrix-free operator: gmg without assembled_matvec, on a
    forest of more than one level; f64 whatever the precision),
    "assembled" (the stored-element-matrix Jacobi CG, also where the
    Galerkin chain is empty) or "matrix-free" (the matrix-free Jacobi
    CG, with mixed precision one capped f32 pass and an f64
    correction)."""
    if sys.lattice_hierarchy is not None:
        return "lattice"
    if sys.params.assembled_matvec and sys.galerkin_hierarchy is not None:
        return "galerkin"
    if sys.hierarchy is not None:
        return "geometric"
    return "assembled" if sys.params.assembled_matvec else "matrix-free"


def uses_direct(sys) -> bool:
    """Whether the configured solve is the dense direct one: `direct`,
    or `auto` up to DENSE_DIRECT_MAX_DOFS, whatever the
    preconditioner."""
    mode = sys.params.linear_solver
    return mode == "direct" or (
        mode == "auto"
        and sys.mesh.n_dofs <= linear.DENSE_DIRECT_MAX_DOFS)


def check_linear_solver(sys) -> str:
    """The linear solve a replicated Newton will take: "direct" or one
    of `krylov_path`'s names.  A singular direct factor falls through
    to `krylov_path`."""
    return "direct" if uses_direct(sys) else krylov_path(sys)


def _solve(sys, u, phi, phi_old, phi_oold, con, active, rhs_u, rhs_p,
           with_split):
    """The configured linear solve. Returns (du, dp, iterations).

    A configuration whose displacement block is exactly singular inside
    a fully developed crack (K reg = 0) makes the dense factor singular;
    the reference solves those with a Krylov method whose iterates stay
    in the range space (GMRES, cracks.cc:2762-2771), so a singular
    factor -- or `linear_solver=direct` above the dense cap -- falls
    through to the Krylov path, which has the same property."""
    if uses_direct(sys):
        try:
            return linear.solve_direct(
                u, phi, phi_old, phi_oold, sys.ca_all, sys.scalars, con,
                active, rhs_u, rhs_p, dim=sys.dim, with_split=with_split,
                monolithic=sys.monolithic, cs=sys.cell_scatter)
        except linear.DirectSolveRefused:
            pass
    path = krylov_path(sys)
    if path == "lattice":
        du, dp, its = lattice.solve_lattice(sys, u, phi, phi_old, phi_oold,
                                            active, rhs_u, rhs_p, with_split)
        du, dp = expand_update(du, dp, con, active)
        return du, dp, its
    if path in ("galerkin", "assembled"):
        return _solve_assembled(sys, u, phi, phi_old, phi_oold, con, active,
                                rhs_u, rhs_p, with_split)
    return _solve_matrix_free(sys, u, phi, phi_old, phi_oold, con, active,
                              rhs_u, rhs_p, with_split)


def _norm(ru, rp) -> float:
    return math.sqrt(float(torch.dot(ru, ru) + torch.dot(rp, rp)))


def _solve_assembled(sys, u, phi, phi_old, phi_oold, con, active, rhs_u,
                     rhs_p, with_split):
    """Stored-element-matrix solve (JAX ``newton._solve_assembled``).
    With the Galerkin hierarchy: the mixed-precision split solve
    (`galerkin.solve_split`, at every size, with the JAX fused
    variant's target where JAX fuses: that variant serves only the
    TPU's dispatch latency), or without mixed
    precision the f64 Galerkin-preconditioned block CG on the element
    Jacobians.  Without it, Jacobi CG on the element Jacobians; with
    mixed precision, iterative refinement: up to 8 capped f32 passes,
    each accepted if it cuts the f64 residual below 0.2x, the first
    stalled one replaced by an f64 Jacobi-CG finish.  Returns
    (du, dp, iterations) with the constraints distributed."""
    p = sys.params
    ghier = sys.galerkin_hierarchy
    if ghier is not None and sys.mixed_precision:
        du, dp, its = galerkin.solve_split(sys, ghier, u, phi, phi_old,
                                           phi_oold, con, active, rhs_u,
                                           rhs_p, with_split)
        return (*expand_update(du, dp, con, active), its)
    kw = dict(dim=sys.dim, with_split=with_split, monolithic=sys.monolithic)
    cs = sys.cell_scatter
    bnorm0 = _norm(rhs_u, rhs_p)

    def krylov(jac_, ca_, con_, bu, bp, rtol, atol, maxiter):
        d_u, d_p = assembled.diagonals(jac_, ca_, cs, dim=sys.dim)
        return assembled.solve_cg_block(
            jac_, ca_, con_, active, bu, bp, d_u, d_p, rtol, atol, cs,
            dim=sys.dim, maxiter=maxiter, stall_window=p.cg_chunk)

    jac = assembled.build_jacobians(u, phi, phi_old, phi_oold, sys.ca,
                                    sys.scalars, cs=cs, **kw)
    if ghier is not None:
        du, dp, its = galerkin.solve_cg_block(
            ghier, jac, sys.galerkin_fine, sys.ca, cs, con, active, rhs_u,
            rhs_p, p.cg_rtol, 1e-300, dim=sys.dim, maxiter=p.cg_maxiter,
            chunk=p.cg_chunk)
        return (*expand_update(du, dp, con, active), its)
    if not sys.mixed_precision:
        du, dp, its = krylov(jac, sys.ca, con, rhs_u, rhs_p, p.cg_rtol,
                             1e-300, p.cg_maxiter)
        return (*expand_update(du, dp, con, active), its)

    f32 = lambda x: x.to(torch.float32)
    con32 = con._replace(hang_weights=f32(con.hang_weights),
                         hang_weights_u=f32(con.hang_weights_u))
    sc32 = physics.Scalars(*(f32(v) for v in sys.scalars))
    jac32 = assembled.build_jacobians(
        f32(u), f32(phi), f32(phi_old), f32(phi_oold), sys.ca32, sc32,
        cs=cs, **kw)
    target = max(p.cg_rtol * bnorm0, 1e-300)
    du = torch.zeros_like(u)
    dp = torch.zeros_like(phi)
    ru, rp = rhs_u, rhs_p
    rnorm = bnorm0
    total_its = 0
    for _ in range(8):
        cu32, cp32, its = krylov(jac32, sys.ca32, con32, f32(ru), f32(rp),
                                 max(p.cg_rtol, 1e-4), 1e-300,
                                 min(p.cg_maxiter, 4 * p.cg_chunk))
        total_its += its
        du_try = du + cu32.to(u.dtype)
        dp_try = dp + cp32.to(u.dtype)
        ru2, rp2 = assembled.residual_update(jac, sys.ca, con, active, cs,
                                             du_try, dp_try, rhs_u, rhs_p,
                                             dim=sys.dim)
        rnorm2 = _norm(ru2, rp2)
        if rnorm2 < 0.2 * rnorm:        # False for a non-finite rnorm2
            du, dp, ru, rp, rnorm = du_try, dp_try, ru2, rp2, rnorm2
            if rnorm <= target:
                break
            continue
        # the f32 floor, or overflow on a noise-level rhs (Newton going
        # on past the f64 residual floor while the active set still
        # changes): drop the pass and finish with f64 Jacobi CG
        cu, cp, it64 = krylov(jac, sys.ca, con, ru, rp, p.cg_rtol, target,
                              p.cg_maxiter)
        total_its += it64
        du = du + cu
        dp = dp + cp
        break
    return (*expand_update(du, dp, con, active), total_its)


def _solve_matrix_free(sys, u, phi, phi_old, phi_oold, con, active, rhs_u,
                       rhs_p, with_split):
    """The matrix-free solve (JAX ``newton._solve`` without
    assembled_matvec).  With the geometric hierarchy: the f64
    GMG-preconditioned block CG to cg_rtol (mixed precision is not used
    there, as in JAX).  Without it, the Jacobi block CG on the analytic
    diagonal; with mixed precision, first one f32 pass on the f32 cell
    arrays (at most min(cg_maxiter, 10 cg_chunk) iterations, relative
    tolerance max(cg_rtol, 1e-4)), then the f64 correction solve on the
    f64 jvp residual to an absolute tolerance of cg_rtol |b|.  Returns
    (du, dp, iterations) with the constraints distributed."""
    p = sys.params
    kw = dict(dim=sys.dim, with_split=with_split, monolithic=sys.monolithic)
    cs = sys.cell_scatter
    if sys.hierarchy is not None:
        return linear.solve_cg_gmg(
            u, phi, phi_old, phi_oold, sys.ca, sys.scalars, cs, con, active,
            rhs_u, rhs_p, sys.hierarchy, p.cg_rtol, 1e-300,
            maxiter=p.cg_maxiter, **kw)
    total_its = 0
    du = dp = None
    atol = 1e-300
    if sys.mixed_precision:
        # iterative refinement: the capped f32 pass takes the cheap
        # iterations, the f64 correction finishes to the tolerance (f32
        # CG stagnates at its kappa*eps floor late in Newton)
        f32 = lambda x: x.to(torch.float32)
        con32 = con._replace(hang_weights=f32(con.hang_weights),
                             hang_weights_u=f32(con.hang_weights_u))
        sc32 = physics.Scalars(*(f32(v) for v in sys.scalars))
        args32 = (f32(u), f32(phi), f32(phi_old), f32(phi_oold))
        diag_u, diag_p = physics.jacobi_diagonal_approx(
            *args32, sys.ca32, sc32, cs, dim=sys.dim,
            monolithic=sys.monolithic)
        du32, dp32, its = linear.solve_cg_block(
            *args32, sys.ca32, sc32, cs, con32, active, f32(rhs_u),
            f32(rhs_p), diag_u, diag_p, max(p.cg_rtol, 1e-4), 1e-300,
            maxiter=linear.chunked_maxiter(
                min(p.cg_maxiter, 10 * p.cg_chunk), p.cg_chunk), **kw)
        total_its += its
        du = du32.to(u.dtype)
        dp = dp32.to(u.dtype)
        ju, jp = physics.jacobian_vector_product(
            u, phi, du, dp, phi_old, phi_oold, sys.ca, sys.scalars, cs, **kw)
        ju, jp = condense_residual(ju, jp, con, active)
        atol = max(p.cg_rtol * _norm(rhs_u, rhs_p), 1e-300)
        rhs_u = rhs_u - ju
        rhs_p = rhs_p - jp
    diag_u, diag_p = physics.jacobi_diagonal_approx(
        u, phi, phi_old, phi_oold, sys.ca, sys.scalars, cs, dim=sys.dim,
        monolithic=sys.monolithic)
    cu, cp, its = linear.solve_cg_block(
        u, phi, phi_old, phi_oold, sys.ca, sys.scalars, cs, con, active,
        rhs_u, rhs_p, diag_u, diag_p, p.cg_rtol, atol,
        maxiter=linear.chunked_maxiter(p.cg_maxiter, p.cg_chunk), **kw)
    total_its += its
    if du is None:
        return cu, cp, total_its
    return du + cu, dp + cp, total_its


def _seam_residual(sys, u, phi, phi_old, phi_oold, with_split):
    """The residual of a seam lattice: the lattice layout's conjugated
    window residual (`lattice_newton._lat_residual_seam`) of this
    process's rows (the whole lattice in one process), lifted from and
    mapped back to flat vectors, every process's rows gathered on W
    ranks, so that the replicated run and the lattice-layout runs of a
    slit mesh, on any number of row slabs or ranks, assemble the same
    bits."""
    from .lattice_newton import _lat_residual_seam
    hier = sys.lattice_hierarchy
    vp, dim, sl = hier.vert_pos, sys.dim, hier.slabs[-1]
    rows = lambda x, k: lattice.rows_of(sys, x, k)
    RU, RP = _lat_residual_seam(
        rows(u, dim), rows(phi, 1), rows(phi_old, 1), rows(phi_oold, 1),
        sys.lattice_ca64, sys.scalars, dim=dim, with_split=with_split,
        monolithic=sys.monolithic, seam=hier.seam, sl=sl)
    R = sl.gather(torch.cat([RU, RP]))
    return lattice._to_glob(R[:dim], vp, dim), lattice._to_glob(R[dim:], vp, 1)


def _assemble(sys, u, phi, phi_old, phi_oold, con, active, with_split):
    """(tot_p, pde_u, pde_p): the hanging-condensed raw phase-field
    residual (the indicator's input) and the condensed Newton rhs (on a
    seam lattice assembled as the lattice layout assembles it,
    `_seam_residual`)."""
    hier = sys.lattice_hierarchy
    if hier is not None and hier.seam is not None:
        ru, rp = _seam_residual(sys, u, phi, phi_old, phi_oold, with_split)
    else:
        ru, rp = physics.assemble_residual(
            u, phi, phi_old, phi_oold, sys.ca, sys.scalars,
            sys.cell_scatter, dim=sys.dim, with_split=with_split,
            monolithic=sys.monolithic)
    tot_p = hanging_transpose_p(rp, con)
    pde_u, pde_p = condense_residual(ru, rp, con, active)
    return tot_p, pde_u, pde_p


def _active_set_update(sys, u, phi, phi_old, phi_oold, tot_p, pde_u_in,
                       pde_p_in, resid_ok, active_old, cycling, hang_mask,
                       c_weight, con, *, with_split, can_skip):
    """The PDAS iteration head: indicator, set update, pinning, hanging
    distribution, re-assembly, condensation and the bookkeeping
    (cracks.cc:2822-2918).

    With can_skip (hanging-node-free meshes) an unchanged active set
    skips the re-assembly: the Newton update is zero on constrained
    dofs, so the residuals in hand — assembled at exactly this (u, phi)
    — ARE this head's residuals.  `resid_ok` is False after a fully
    failed line search, whose last trial residual does not belong to
    the restored iterate.  Returns the new (u, phi, active, tot_p,
    pde_u, pde_p) and a dict of host scalars."""
    sc = sys.scalars
    gap = phi - phi_old
    indicator = tot_p / sys.diag_mass + c_weight * gap
    # The reference tests `indicator > 0` (cracks.cc:2865) and relies on
    # the bulk residual being exactly zero away from the crack; a tiny
    # floor scaled by the problem's stress scales keeps rounding noise
    # (e.g. run-to-run atomics in the CUDA scatter-add) from activating
    # bulk dofs, far below any genuine activation.
    atol = 1e-12 * max(c_weight, float(sc.G_c) / float(sc.alpha_eps))
    active = ((indicator > atol) | cycling) & ~hang_mask
    phi = torch.where(active, phi_old, phi)
    phi = hanging_interpolate_p(phi, con)
    u = hanging_interpolate_u(u, con)
    flipped = active != active_old
    changed = int(flipped.sum())
    if not (can_skip and changed == 0 and resid_ok):
        tot_p, pde_u, pde_p = _assemble(sys, u, phi, phi_old, phi_oold, con,
                                        active, with_split)
    else:
        pde_u, pde_p = pde_u_in, pde_p_in
    # complementarity diagnostics: the largest |indicator| among the
    # dofs that changed status and the constraint-force scale (largest
    # indicator over the active set), for the settled-set band
    stats = dict(
        n_active=int(active.sum()),
        n_cycling=int((active & cycling).sum()),
        changed=changed,
        ind_flip_max=float(torch.where(flipped, indicator.abs(), 0.0).max()),
        ind_act_max=float(torch.where(active, indicator, 0.0).max()))
    left = active_old & ~active
    return (u, phi, active, tot_p, pde_u, pde_p, left), stats


def _line_search(sys, u, phi, du, dp, phi_old, phi_oold, active, con,
                 res0, damping, *, with_split, max_steps):
    """Backtracking line search (cracks.cc:2940-2957): trial k steps by
    du * damping**k; accept the first trial whose residual decreases.
    On total failure the solution is restored but the residuals in hand
    are the last trial's (the reference's member-variable bookkeeping).
    Returns (u, phi, tot_p, pde_u, pde_p, residual, k)."""
    k = 0
    while True:
        scale = damping ** k
        ut = u + du * scale
        pt = phi + dp * scale
        tot_p, pde_u, pde_p = _assemble(sys, ut, pt, phi_old, phi_oold, con,
                                        active, with_split)
        res = float(residual_norm(pde_u, pde_p))
        if res < res0:
            return ut, pt, tot_p, pde_u, pde_p, res, k
        if k >= max_steps - 1:
            return u, phi, tot_p, pde_u, pde_p, res, k
        k += 1


def _flips_within_band(newton_step, ind_flip_max, ind_act_max,
                       active_set_rel_tol, c_weight, G_c, alpha_eps):
    """Marginal-dof complementarity band of the PDAS convergence test:
    whether every status flip this iteration has |indicator| within
    `active_set_rel_tol` of zero relative to the constraint-force scale
    (such a dof satisfies discrete complementarity in either status),
    plus the band for logging.  Never fires before the second Newton
    iteration, and keeps an absolute floor of 10x the indicator noise
    floor."""
    if newton_step < 2:
        return False, 0.0
    atol_ind = 1e-12 * max(c_weight, G_c / max(alpha_eps, 1e-300))
    ind_band = max(active_set_rel_tol * ind_act_max, 1e1 * atol_ind)
    return ind_flip_max <= ind_band, ind_band


def newton_active_set(sys, state, time: float, verbose: bool = True):
    """Primal-dual active set Newton (cracks.cc:2780-2994).

    `sys` is a driver.System; `state` a driver.SolutionState with
    tensors u, phi (current) and u_old, phi_old, phi_oold.  Sets
    state.u/state.phi and returns the last residual reduction."""
    check_linear_solver(sys)
    p = sys.params
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)

    con = sys.constraints(time)
    with_split = sys.with_split
    phi_old, phi_oold = state.phi_old, state.phi_oold

    # set_initial_bc + hanging distribute (cracks.cc:2787-2788)
    u, phi = sys.apply_initial_bc(state.u, state.phi, time)
    u = hanging_interpolate_u(u, con)
    phi = hanging_interpolate_p(phi, con)

    n_v = sys.mesh.n_vertices
    dev = phi.device
    active = torch.zeros(n_v, dtype=torch.bool, device=dev)
    tot_p, pde_u, pde_p = _assemble(sys, u, phi, phi_old, phi_oold, con,
                                    active, with_split)
    newton_residual = float(residual_norm(pde_u, pde_p))
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    cycle_counter = torch.zeros(n_v, dtype=torch.int64, device=dev)
    hang_mask = torch.as_tensor(sys.mesh.hanging_mask(), device=dev)
    c_weight = 1e1 * p.E_modulus  # cracks.cc:2859
    n_cycling_threshold = 5       # cracks.cc:2866
    can_skip = con.hang_child_p.numel() == 0
    resid_ok = True

    newton_step = 0
    sum_lin_it = 0
    new_newton_residual = 0.0
    while True:
        active_old = active
        cycling = cycle_counter >= n_cycling_threshold
        (u, phi, active, tot_p, pde_u, pde_p, left), st = _active_set_update(
            sys, u, phi, phi_old, phi_oold, tot_p, pde_u, pde_p, resid_ok,
            active_old, cycling, hang_mask, c_weight, con,
            with_split=with_split, can_skip=can_skip)
        # cycle detection: count dofs that LEFT the set (cracks.cc:2901)
        cycle_counter = cycle_counter + left

        du, dp, n_lin = _solve(sys, u, phi, phi_old, phi_oold, con, active,
                               pde_u, pde_p, with_split)
        sum_lin_it += n_lin

        u, phi, tot_p, pde_u, pde_p, new_newton_residual, line_search_step = \
            _line_search(sys, u, phi, du, dp, phi_old, phi_oold, active,
                         con, newton_residual, p.line_search_damping,
                         with_split=with_split,
                         max_steps=max(1, p.max_no_line_search_steps))
        # a fully failed search leaves the last trial's residual in hand
        resid_ok = new_newton_residual < newton_residual

        log.print_line(
            newton_step + 1, st["n_active"], st["n_cycling"],
            f"{new_newton_residual:.6e}",
            f"{new_newton_residual / newton_residual:.6e}",
            line_search_step, n_lin, verbose=verbose)

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        newton_step += 1

        # Convergence (cracks.cc:2971-2973): residual below the bound
        # AND the active set settled — exactly unchanged, or every flip
        # inside the complementarity band (the marginal-dof peel seen at
        # 1M+ DoFs; see the JAX module for the measurements).
        set_settled = st["changed"] == 0
        if not set_settled:
            in_band, ind_band = _flips_within_band(
                newton_step, st["ind_flip_max"], st["ind_act_max"],
                p.active_set_rel_tol, c_weight,
                float(sys.scalars.G_c), float(sys.scalars.alpha_eps))
            if in_band:
                set_settled = True
                log.print_line(
                    f"\tActive set settled: {st['changed']} flips within "
                    f"complementarity band {ind_band:.3e} "
                    f"(|ind|max {st['ind_flip_max']:.3e})", verbose=verbose)
        if newton_residual < p.lower_bound_newton_residual and set_settled:
            log.print_line(f"\tNewton iterations: {newton_step} "
                           f"total linear iterations: {sum_lin_it}",
                           verbose=verbose)
            break
        if newton_step >= p.max_no_newton_steps:
            if verbose:
                print(f"Newton iteration did not converge in {newton_step} "
                      "steps.")
            raise NoConvergence()

    state.u = u
    state.phi = phi
    state.active_mask = active.cpu().numpy()
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    state.last_log = log
    return new_newton_residual / old_newton_residual


def newton_iteration(sys, state, time: float, verbose: bool = True):
    """Penalized monolithic Newton with Jacobian reuse
    (cracks.cc:2997-3107): no active set, the irreversibility penalized
    through gamma; the Jacobian is rebuilt at the current iterate when
    the residual fell by less than nonlinear_rho = 0.1, else the last
    linearization point is kept; a damped backtracking line search on
    the residual's max norm.  Sets state.u/state.phi and state.last_log
    and returns the last residual reduction, which the driver holds
    against upper_newton_rho."""
    check_linear_solver(sys)
    p = sys.params
    log = NewtonLog()
    log.print_line("It.", "Residual", "Reduction", "LSrch", "#LinIts",
                   verbose=verbose)
    nonlinear_rho = 0.1  # cracks.cc:3007

    con = sys.constraints(time)
    with_split = sys.with_split
    phi_old, phi_oold = state.phi_old, state.phi_oold
    u, phi = sys.apply_initial_bc(state.u, state.phi, time)
    active = torch.zeros(sys.mesh.n_vertices, dtype=torch.bool,
                         device=phi.device)

    def assemble(u_, phi_):
        ru, rp = physics.assemble_residual(
            u_, phi_, phi_old, phi_oold, sys.ca, sys.scalars,
            sys.cell_scatter, dim=sys.dim, with_split=with_split,
            monolithic=True)
        pde = condense_residual(ru, rp, con, active)
        return pde, float(residual_linfty(*pde))

    _, newton_residual = assemble(u, phi)
    old_newton_residual = newton_residual
    newton_step = 1
    log.print_line(0, f"{newton_residual:.6e}", verbose=verbose)
    u_lin, phi_lin = u, phi      # the linearization point

    while (newton_residual > p.lower_bound_newton_residual
           and newton_step < p.max_no_newton_steps):
        old_newton_residual = newton_residual
        (pde_u, pde_p), newton_residual = assemble(u, phi)
        if newton_residual < p.lower_bound_newton_residual:
            log.print_line("", f"{newton_residual:.6e}", verbose=verbose)
            break
        if (newton_step == 1
                or newton_residual / old_newton_residual > nonlinear_rho):
            u_lin, phi_lin = u, phi
        du, dp, n_lin = _solve(sys, u_lin, phi_lin, phi_old, phi_oold, con,
                               active, pde_u, pde_p, with_split)
        log.linear_iterations += n_lin

        line_search_step = 0
        new_newton_residual = newton_residual
        for line_search_step in range(p.max_no_line_search_steps):
            u = u + du
            phi = phi + dp
            _, new_newton_residual = assemble(u, phi)
            if new_newton_residual < newton_residual:
                break
            u = u - du
            phi = phi - dp
            du = du * p.line_search_damping
            dp = dp * p.line_search_damping

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        log.print_line(newton_step, f"{newton_residual:.6e}",
                       f"{newton_residual / old_newton_residual:.6e}",
                       line_search_step, n_lin, verbose=verbose)
        if (newton_residual / old_newton_residual > p.upper_newton_rho
                and newton_step > 1):
            break
        newton_step += 1

    if (newton_residual > p.lower_bound_newton_residual
            and newton_step == p.max_no_newton_steps):
        if verbose:
            print(f"Newton iteration did not converge in {newton_step} "
                  "steps :-(")
        raise NoConvergence()

    state.u = u
    state.phi = phi
    log.newton_steps = newton_step
    state.last_log = log
    return newton_residual / old_newton_residual
