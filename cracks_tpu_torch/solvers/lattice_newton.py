"""Primal-dual active set Newton on lattice-layout state (torch).

Port of ``cracks_tpu/solvers/lattice_newton.py``: the PDAS loop of
`newton.newton_active_set`
(cracks.cc:2780-2994) with every DoF vector in lattice layout
(k, gyp, ...) -- the leading grid axis padded with zero rows to the
sharded extent gyp (``parallel/sharding.py``; gyp = G0 without a shard
mesh).  Selected by ``dof_sharding = lattice`` for any n_devices >= 1
with the active-set solver, as in JAX.  On a seam lattice (the slit
meshes) every state vector is canonical and every residual is
conjugated as collect . residual . spread (`lattice.Seam`).

Every function here works on a process's rows of the lattice (the
finest level's `Slab`, ``parallel/sharding.py``): the whole lattice in
one process, as JAX's global view, where GSPMD partitions it; on W
ranks the rank's shards' rows.  The window residual of a process's rows
reads the neighbour processes' boundary rows of the state (one exchange)
and computes the cells next to them itself; every norm, count and
maximum is a total over all processes (`Slab.dots`, `Slab.amax`), so
every process holds the same bits and leaves every loop with the
others.
Each head slices its padded inputs back to the real rows on entry (so
no pad row is ever divided by its zero lumped mass) and pads its
outputs on exit.  Flat vectors appear only at the boundary: the initial
boundary values in, the driver state out (gathered from every process).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharding import Slab, pad_rows, unpad_rows, whole
from . import lattice
from .newton import NewtonLog, NoConvergence, _flips_within_band


def _lat_residual_seam(U, P, P_old, P_oold, caL, sc, *, dim, with_split,
                       monolithic, seam, sl: Slab | None = None):
    """The canonical lattice residual of a process's rows: spread the
    seam so the window stencil sees both slit lips, collect the mirror
    contributions back (S^T r for the duplication map S; the plain
    residual without a seam).  The neighbours' boundary rows of the
    state arrive in one exchange, spread after it where the seam
    straddles a rank boundary (`lattice.seam_ext`); the cells next to
    them (caL: the process's held cells) are computed here, so each
    owned row sums its cells as the global residual does.  Without `sl`,
    the whole lattice."""
    if sl is None:
        sl = whole(U.shape[1])
    RU, RP = lattice.lattice_residual(
        *lattice.seam_ext(sl, seam, U, P, P_old, P_oold), caL, sc, dim=dim,
        with_split=with_split, monolithic=monolithic, rows=sl.g,
        first=sl.e0)
    return lattice.seam_collect_rows((sl.owned(RU), sl.owned(RP)), seam, sl)


def _condensed_residual(U, P, P_old, P_oold, active, dir_u, dir_p, caL, sc,
                        *, dim, with_split, monolithic, seam, sl: Slab):
    """The raw phase-field rhs and the condensed Newton rhs (zero on
    Dirichlet and active dofs, and on a seam's mirror slots, which the
    Dirichlet masks pin) at true-shaped lattice state, and its norm (a
    0-d tensor, `Slab.dots`)."""
    RU, RP = _lat_residual_seam(U, P, P_old, P_oold, caL, sc, dim=dim,
                                with_split=with_split, monolithic=monolithic,
                                seam=seam, sl=sl)
    pu = torch.where(dir_u, 0.0, RU)
    pp = torch.where(dir_p | active, 0.0, RP)
    sq = sl.dots((pu, pu), (pp, pp))
    return RP, pu, pp, torch.sqrt(sq[0] + sq[1])


def _initial_assemble_lat(U, P, P_old, P_oold, active, dir_u, dir_p, caL,
                          sc, *, grid, dim, with_split, monolithic, gyp,
                          seam, sl: Slab):
    """Initial residual assembly and condensation (cracks.cc:2790-2791),
    padded in and out.  Returns (tot_p, pde_u, pde_p, residual norm)."""
    up = lambda X: unpad_rows(X, sl.n)
    RP, pu, pp, res = _condensed_residual(
        up(U), up(P), up(P_old), up(P_oold), up(active), up(dir_u),
        up(dir_p), caL, sc, dim=dim, with_split=with_split,
        monolithic=monolithic, seam=seam, sl=sl)
    return pad_rows(RP, gyp), pad_rows(pu, gyp), pad_rows(pp, gyp), res


def _fused_active_set_update_lat(U, P, P_old, P_oold, tot_p, pde_u_in,
                                 pde_p_in, resid_ok, active_old, cycling,
                                 dir_u, dir_p, diag_mass, c_weight, caL, sc,
                                 *, grid, dim, with_split, monolithic,
                                 can_skip, gyp, seam, sl: Slab):
    """The PDAS iteration head on padded lattice-layout state: indicator,
    set update, pinning, re-assembly, condensation and the bookkeeping
    (cracks.cc:2822-2918); `newton._active_set_update` without the
    hanging-node machinery (a lattice has none).  With can_skip an
    unchanged set after an accepted line search keeps the residuals in
    hand (a host `if`, where JAX has a ``lax.cond``).  Returns the padded
    (U, P, active, tot_p, pde_u, pde_p) and a dict of host scalars with
    the padded `left` mask on the host; the counts and maxima are totals
    over all processes."""
    up = lambda X: unpad_rows(X, sl.n)
    U, P, P_old, P_oold = up(U), up(P), up(P_old), up(P_oold)
    active_old, cycling = up(active_old), up(cycling)
    dir_u, dir_p, diag_mass = up(dir_u), up(dir_p), up(diag_mass)
    gap = P - P_old
    # guard the divide as JAX does (lattice_newton.py:81): a seam
    # lattice's mirror slots carry no lumped mass (the indicator there is
    # 0: its residual and gap are canonical zeros)
    diag_safe = torch.where(diag_mass > 0, diag_mass, 1.0)
    indicator = up(tot_p) / diag_safe + c_weight * gap
    # the absolute indicator floor of newton._active_set_update
    atol = 1e-12 * max(c_weight, float(sc.G_c) / float(sc.alpha_eps))
    active = (indicator > atol) | cycling
    P = torch.where(active, P_old, P)
    flipped = active != active_old
    counts = sl.sum_ranks(torch.stack([
        flipped.sum(), active.sum(), (active & cycling).sum()])).tolist()
    changed = counts[0]
    if can_skip and changed == 0 and resid_ok:
        tot_p, pde_u, pde_p = tot_p, pde_u_in, pde_p_in
    else:
        RP, pu, pp, _ = _condensed_residual(
            U, P, P_old, P_oold, active, dir_u, dir_p, caL, sc, dim=dim,
            with_split=with_split, monolithic=monolithic, seam=seam, sl=sl)
        tot_p, pde_u, pde_p = (pad_rows(X, gyp) for X in (RP, pu, pp))
    tops = sl.amax(torch.stack([
        torch.where(flipped, indicator.abs(), 0.0).amax(),
        torch.where(active, indicator, 0.0).amax()])).tolist()
    stats = dict(
        n_active=counts[1],
        n_cycling=counts[2],
        changed=changed,
        left=pad_rows(active_old & ~active, gyp).cpu().numpy(),
        ind_flip_max=tops[0],
        ind_act_max=tops[1])
    return (pad_rows(U, gyp), pad_rows(P, gyp), pad_rows(active, gyp), tot_p,
            pde_u, pde_p), stats


def _fused_line_search_lat(U, P, DU, DP, P_old, P_oold, active, dir_u, dir_p,
                           caL, sc, res0, damping, *, grid, dim, with_split,
                           monolithic, max_steps, gyp, seam, sl: Slab):
    """Backtracking line search on padded lattice-layout state
    (cracks.cc:2940-2957), a host loop where JAX has a
    ``lax.while_loop``: trial k steps by DU * damping**k and accepts the
    first trial whose residual decreases.  A fully failed search
    restores the iterate but keeps the last trial's residuals.  Returns
    padded (U, P, tot_p, pde_u, pde_p), the residual and k."""
    up = lambda X: unpad_rows(X, sl.n)
    U, P, DU, DP = up(U), up(P), up(DU), up(DP)
    P_old, P_oold, active = up(P_old), up(P_oold), up(active)
    dir_u, dir_p = up(dir_u), up(dir_p)
    k = 0
    while True:
        scale = damping ** k
        Ut = U + DU * scale
        Pt = P + DP * scale
        RP, pu, pp, res_d = _condensed_residual(
            Ut, Pt, P_old, P_oold, active, dir_u, dir_p, caL, sc, dim=dim,
            with_split=with_split, monolithic=monolithic, seam=seam, sl=sl)
        res = float(res_d)
        accepted = res < res0
        if accepted or k >= max_steps - 1:
            break
        k += 1
    if accepted:
        U, P = Ut, Pt
    return (*(pad_rows(X, gyp) for X in (U, P, RP, pu, pp)), res, k)


def newton_active_set_lattice(sys, state, time: float, verbose: bool = True):
    """PDAS Newton on lattice-layout state.  Same contract as
    `newton.newton_active_set`: sets state.u/state.phi (flat, at the
    boundary), state.active_mask and state.last_log, and returns the
    last residual reduction.  Like the JAX lattice Newton it never reads
    `linear_solver`: the driver selects it only where the lattice
    hierarchy exists, and its solve is the lattice one.  On W ranks each
    rank cuts its shards' rows from the flat state at entry and the
    flat state at exit is gathered from every rank's rows."""
    p = sys.params
    hier: lattice.LatticeHierarchy = sys.lattice_hierarchy
    grid = hier.grid
    dim = sys.dim
    vert_pos = hier.vert_pos
    # the process's rows of the finest level (a seam lattice's too),
    # padded to its shards' rows
    sl = hier.slabs[-1]
    gyp = lattice.local_rows(sys)
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)
    with_split = sys.with_split
    kw = dict(grid=grid, dim=dim, with_split=with_split,
              monolithic=sys.monolithic, gyp=gyp, seam=hier.seam, sl=sl)

    def place(x, k):
        return pad_rows(lattice.rows_of(sys, x, k), gyp).contiguous()

    # boundary: flat state in, the inhomogeneous boundary values applied
    # flat (set_initial_bc, cracks.cc:2787), then lifted to the padded
    # lattice layout (canonical on a seam lattice: no vertex sits on a
    # mirror slot).  diag_mass pad rows are zero; the head slices them
    # away before dividing.
    u, phi = sys.apply_initial_bc(state.u, state.phi, time)
    U, P = place(u, dim), place(phi, 1)
    P_old, P_oold = place(state.phi_old, 1), place(state.phi_oold, 1)
    diag_mass = place(sys.diag_mass.to(torch.float64), 1)
    dir_u = pad_rows(hier.dir_u[-1], gyp)
    dir_p = pad_rows(hier.dir_p[-1], gyp)
    caL = sys.lattice_ca64
    sc = sys.scalars

    active = torch.zeros((1, gyp) + grid[1:], dtype=torch.bool,
                         device=U.device)
    tot_p, pde_u, pde_p, res0_d = _initial_assemble_lat(
        U, P, P_old, P_oold, active, dir_u, dir_p, caL, sc, **kw)
    newton_residual = float(res0_d)
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    # host-side, as in JAX: counts how often each dof LEFT the set
    cycle_counter = np.zeros((1, gyp) + grid[1:], dtype=np.int64)
    c_weight = 1e1 * p.E_modulus   # cracks.cc:2859
    n_cycling_threshold = 5        # cracks.cc:2866
    resid_ok = True

    newton_step = 0
    sum_lin_it = 0
    new_newton_residual = 0.0
    while True:
        active_old = active
        cycling = torch.as_tensor(cycle_counter >= n_cycling_threshold,
                                  device=U.device)
        (U, P, active, tot_p, pde_u, pde_p), st = \
            _fused_active_set_update_lat(
                U, P, P_old, P_oold, tot_p, pde_u, pde_p, resid_ok,
                active_old, cycling, dir_u, dir_p, diag_mass, c_weight, caL,
                sc, can_skip=True, **kw)
        cycle_counter[st["left"]] += 1

        DU, DP, n_lin = lattice.solve_lattice_lat(
            sys, U, P, P_old, P_oold, active, pde_u, pde_p, with_split)
        # distribute: the Newton update is zero on Dirichlet and active
        # dofs (pad rows of the masks are False and DU/DP's are zero)
        DU = torch.where(dir_u, 0.0, DU)
        DP = torch.where(dir_p | active, 0.0, DP)
        sum_lin_it += n_lin

        U, P, tot_p, pde_u, pde_p, new_newton_residual, line_search_step = \
            _fused_line_search_lat(
                U, P, DU, DP, P_old, P_oold, active, dir_u, dir_p, caL, sc,
                newton_residual, p.line_search_damping,
                max_steps=max(1, p.max_no_line_search_steps), **kw)
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

        # convergence: residual below the bound AND the set settled
        # (exactly unchanged, or every flip inside the complementarity
        # band; see newton.newton_active_set)
        set_settled = st["changed"] == 0
        if not set_settled:
            in_band, ind_band = _flips_within_band(
                newton_step, st["ind_flip_max"], st["ind_act_max"],
                p.active_set_rel_tol, c_weight, float(sc.G_c),
                float(sc.alpha_eps))
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

    # boundary: lattice state out (every process's rows) -> flat driver
    # state
    every = lambda X: sl.gather(unpad_rows(X, sl.n))
    state.u = lattice._to_glob(every(U), vert_pos, dim)
    state.phi = lattice._to_glob(every(P), vert_pos, 1)
    state.active_mask = lattice._to_glob(every(active), vert_pos,
                                         1).cpu().numpy()
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    state.last_log = log
    return new_newton_residual / old_newton_residual
