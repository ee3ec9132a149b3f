"""Primal-dual active set Newton on the owned+ghost halo pool (torch).

Port of ``cracks_tpu/solvers/halo_newton.py``: the sharded-DoF PDAS
Newton for the meshes the tensor-grid lattice cannot hold (hanging
nodes included), selected by ``dof_sharding = lattice`` with more than
one shard where no lattice-layout Newton runs.  Every DoF vector is
(D, n_loc * comps) on the pool of `parallel/halo.py`, slot order per
shard [owned | ghost | pad | trash], and kept owner-canonical in its
results: every assembly refreshes the ghosts through the pool and
applies the hanging interpolation H shard-locally (the partition puts
the masters of every local hanging vertex on the shard); every residual
is distributed with H^T per shard and owner-combined, which is the flat
`ops/constraints.py` condensation of the global sum.

Where JAX runs one ``shard_map`` program per head, the port makes one
batched call over the process's shards; the shards meet only in
`sharding.psum_shards` / `pmax_shards`.  The host drives the loops and
reads one scalar per CG iteration.  On W ranks every control decision
(the CG's stop test, the line search, the active-set bookkeeping and
the Newton stop) reads totals of those collectives, which are equal on
every rank, so no rank leaves a loop that another keeps iterating.

The linear solve is the block-lower-triangular split of the flat path
(u rows see no phi columns, cracks.cc:2353-2366): two Jacobi-
preconditioned CGs on the stored f64 element matrices, each capped at
2000 iterations as in JAX, whatever `cg_maxiter` says (JAX's pooled
Galerkin GMG is a stub that never engages, so `preconditioner = gmg`
also takes Jacobi here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import physics
from ..ops.scatter import scatter_add, scatter_add_rows
from ..parallel import halo
from ..parallel.halo import HaloPartition
from ..parallel.sharding import pmax_shards, psum_shards
from .newton import NewtonLog, NoConvergence, _flips_within_band

# the block CG's iteration cap (JAX build_halo_cg's default, which
# build_halo_solver never overrides)
HALO_CG_MAXITER = 2000


def _psum(part: HaloPartition, x: torch.Tensor) -> torch.Tensor:
    """The total over all shards of per-shard sums of a (D_local, ...)
    tensor: a 0-d tensor."""
    return psum_shards(x.reshape(x.shape[0], -1).sum(dim=1), part.mesh)[0]


def _pmax(part: HaloPartition, x: torch.Tensor) -> torch.Tensor:
    return pmax_shards(x.reshape(x.shape[0], -1).amax(dim=1), part.mesh)[0]


# ---------------------------------------------------------------------------
# shard-local constraint primitives (composed with halo.make_halo_ops)
# ---------------------------------------------------------------------------

def make_hang_ops(part: HaloPartition):
    """(hinterp_u, hinterp_p, htransp_u, htransp_p): the hanging
    interpolation H and distribution H^T in local slot indices, on (D,
    n_loc * comps) vectors.  Pad stencil rows target the trash slot with
    zero weights, so they only re-zero it."""
    arr = part.arrays
    D, n_loc, dim = part.n_local, part.n_loc, part.dim
    shard = torch.arange(D, device=arr.hang_child.device)
    H = arr.hang_child.shape[1]

    def hinterp(x, comps):
        if H == 0:
            return x
        xm = x.reshape(D, n_loc, comps)
        vals = torch.einsum("shm,shmc->shc", arr.hang_weights.to(x.dtype),
                            xm[shard[:, None, None], arr.hang_masters])
        return xm.index_put((shard[:, None], arr.hang_child),
                            vals).reshape(x.shape)

    def htranspose(r, comps):
        if H == 0:
            return r
        rm = r.reshape(D, n_loc, comps)
        vals = rm[shard[:, None], arr.hang_child]            # (D, H, c)
        contrib = arr.hang_weights[..., None].to(r.dtype) * vals[:, :, None]
        rm = scatter_add_rows(part.hang_scatter, contrib.reshape(-1, comps),
                              rm.reshape(D * n_loc, comps).clone())
        rm = rm.reshape(D, n_loc, comps)
        rm = rm.index_put((shard[:, None], arr.hang_child),
                          rm.new_zeros(()))
        # pad stencil rows routed junk through the trash slot
        rm[:, n_loc - 1] = 0.0
        return rm.reshape(r.shape)

    return (lambda x: hinterp(x, dim), lambda x: hinterp(x, 1),
            lambda r: htranspose(r, dim), lambda r: htranspose(r, 1))


def _shard_primitives(part: HaloPartition):
    """The closures the heads and the CG share: the halo and hanging
    ops, `consistent`, `condense` and `free_masks`."""
    gr_u, gr_p, cb_u, cb_p = halo.make_halo_ops(part)
    hi_u, hi_p, ht_u, ht_p = make_hang_ops(part)
    arr = part.arrays
    own_u = arr.own_mask_p.repeat_interleave(part.dim, dim=1)
    hang_u = arr.hang_mask.repeat_interleave(part.dim, dim=1)

    def consistent(u, phi, phi_old, phi_oold):
        """Owner-canonical -> assembly-ready: ghost refresh, then H."""
        return (hi_u(gr_u(u)), hi_p(gr_p(phi)), hi_p(gr_p(phi_old)),
                hi_p(gr_p(phi_oold)))

    def condense(ru, rp):
        """Partial raw residual -> condensed owner rows: per-shard H^T,
        then the owner combine (= H^T of the global sum)."""
        return cb_u(ht_u(ru)), cb_p(ht_p(rp))

    def free_masks(dir_u, dir_p, active):
        free_u = own_u & ~dir_u & ~hang_u
        free_p = arr.own_mask_p & ~dir_p & ~arr.hang_mask & ~active
        return free_u, free_p

    return dict(gr_u=gr_u, gr_p=gr_p, cb_u=cb_u, cb_p=cb_p, hi_u=hi_u,
                hi_p=hi_p, ht_u=ht_u, ht_p=ht_p, consistent=consistent,
                condense=condense, free_masks=free_masks)


def _flat(*xs):
    return tuple(x.reshape(-1) for x in xs)


# ---------------------------------------------------------------------------
# the heads (JAX: one shard_map program each)
# ---------------------------------------------------------------------------

def build_halo_heads(part: HaloPartition, *, with_split: bool,
                     max_steps: int):
    """(initial_assemble, head, line_search) of one PDAS solve on the
    pool (JAX ``build_halo_heads``)."""
    pr = _shard_primitives(part)
    dim = part.dim

    def residual(u, phi, phi_old, phi_oold, sc):
        """The condensed owner rows (tot_u, tot_p) at (u, phi)."""
        ru, rp = physics.assemble_residual(
            *_flat(*pr["consistent"](u, phi, phi_old, phi_oold)), part.ca,
            sc, part.cs, dim=dim, with_split=with_split, monolithic=False)
        return pr["condense"](ru.reshape(u.shape), rp.reshape(phi.shape))

    def norm(pu, pp):
        return torch.sqrt(_psum(part, pu * pu) + _psum(part, pp * pp))

    def initial_assemble(u, phi, phi_old, phi_oold, dir_u, dir_p, sc):
        """(tot_p, pde_u, pde_p, residual norm) at the initial iterate,
        the active set empty."""
        tu, tp = residual(u, phi, phi_old, phi_oold, sc)
        free_u, free_p = pr["free_masks"](dir_u, dir_p,
                                          torch.zeros_like(dir_p))
        pu = torch.where(free_u, tu, 0.0)
        pp = torch.where(free_p, tp, 0.0)
        return tp, pu, pp, norm(pu, pp)

    def head(u, phi, phi_old, phi_oold, tot_p, active_old, cycling, dir_u,
             dir_p, diag_mass, c_weight, sc):
        """The PDAS iteration head (cracks.cc:2822-2918): the indicator
        on owned rows, the set update, pinning, re-assembly,
        condensation and the bookkeeping.  No re-assembly skip: hanging
        meshes disable it on the flat path too."""
        own_p = part.arrays.own_mask_p
        gap = phi - phi_old
        diag_safe = torch.where(diag_mass > 0, diag_mass, 1.0)
        indicator = tot_p / diag_safe + c_weight * gap
        atol = 1e-12 * max(c_weight, float(sc.G_c) / float(sc.alpha_eps))
        active = ((indicator > atol) | cycling) & ~part.arrays.hang_mask & own_p
        phi = torch.where(active, phi_old, phi)
        tot_u, tot_p = residual(u, phi, phi_old, phi_oold, sc)
        free_u, free_p = pr["free_masks"](dir_u, dir_p, active)
        pde_u = torch.where(free_u, tot_u, 0.0)
        pde_p = torch.where(free_p, tot_p, 0.0)
        flipped = (active != active_old) & own_p
        stats = dict(
            n_active=_psum(part, active.long()),
            n_cycling=_psum(part, (active & cycling).long()),
            changed=_psum(part, flipped.long()),
            ind_flip_max=_pmax(part, torch.where(flipped, indicator.abs(),
                                                 0.0)),
            ind_act_max=_pmax(part, torch.where(active, indicator, 0.0)))
        left = active_old & ~active
        return (phi, active, tot_p, pde_u, pde_p, left), stats

    def line_search(u, phi, du, dp, phi_old, phi_oold, active, dir_u, dir_p,
                    res0, damping, sc):
        """Backtracking line search (cracks.cc:2940-2957): trial k steps
        by du * damping**k and accepts the first trial whose residual
        decreases; a failed search restores the iterate but keeps the
        last trial's residuals.  Returns (u, phi, tot_p, pde_u, pde_p,
        residual, k)."""
        free_u, free_p = pr["free_masks"](dir_u, dir_p, active)
        k = 0
        while True:
            scale = damping ** k
            ut = u + du * scale
            pt = phi + dp * scale
            tu, tp = residual(ut, pt, phi_old, phi_oold, sc)
            pu = torch.where(free_u, tu, 0.0)
            pp = torch.where(free_p, tp, 0.0)
            res = float(norm(pu, pp))
            accepted = res < res0
            if accepted or k >= max_steps - 1:
                break
            k += 1
        if accepted:
            u, phi = ut, pt
        return u, phi, tp, pu, pp, res, k

    return initial_assemble, head, line_search


# ---------------------------------------------------------------------------
# the linear solve
# ---------------------------------------------------------------------------

def build_halo_cg(part: HaloPartition, *, with_split: bool):
    """The split solve on the pool (JAX ``build_halo_cg``): the stored
    f64 element matrices at the current iterate, then two
    Jacobi-preconditioned CGs, the u block and the phi block with the
    J_pu du coupling moved to its right-hand side.  A matvec is a local
    gather / einsum / ordered scatter, H^T and the owner combine: the
    surface crosses shards, not the volume.  A block CG iterates while
    |r|^2 > max(rtol, 1e-14)^2 |b|^2 and fewer than HALO_CG_MAXITER
    iterations were taken, and stops at the cap without raising.

    Returns solve(u, phi, phi_old, phi_oold, active, dir_u, dir_p,
    rhs_u, rhs_p, rtol, sc) -> (du, dp, iterations, |b_p2|^2,
    (iterations of the u block, of the phi block))."""
    pr = _shard_primitives(part)
    dim = part.dim
    ca, cs = part.ca, part.cs
    nvc = 2 ** dim
    nud_l = nvc * dim

    def solve(u, phi, phi_old, phi_oold, active, dir_u, dir_p, rhs_u, rhs_p,
              rtol, sc):
        uc, pc, poc, pooc = pr["consistent"](u, phi, phi_old, phi_oold)
        jac = physics.element_matrices(
            *_flat(uc, pc, poc, pooc), ca, sc, dim=dim, with_split=with_split,
            monolithic=False)
        free_u, free_p = pr["free_masks"](dir_u, dir_p, active)

        def apply(blk, x, gather, st, n_out):
            ye = torch.einsum("ijc,jc->ic", blk, x.reshape(-1)[gather])
            return scatter_add(st, ye, x.new_zeros(n_out))

        # the block matvecs on the ghost read of the masked vector
        def mv_u(xg):
            xc = pr["hi_u"](xg)
            y = apply(jac[:nud_l, :nud_l], xc, ca.gather_u, cs.u, cs.n_ud)
            return torch.where(free_u, pr["cb_u"](pr["ht_u"](
                y.reshape(xg.shape))), 0.0)

        def mv_p(xg):
            xc = pr["hi_p"](xg)
            y = apply(jac[nud_l:, nud_l:], xc, ca.gather_p, cs.p, cs.n_p)
            return torch.where(free_p, pr["cb_p"](pr["ht_p"](
                y.reshape(xg.shape))), 0.0)

        def coupling_pu(xu):
            """J_pu xu (phi rows, u columns) for the triangular rhs."""
            xc = pr["hi_u"](pr["gr_u"](torch.where(free_u, xu, 0.0)))
            y = apply(jac[nud_l:, :nud_l], xc, ca.gather_u, cs.p, cs.n_p)
            return torch.where(free_p, pr["cb_p"](pr["ht_p"](
                y.reshape(free_p.shape))), 0.0)

        # Jacobi diagonals of the condensed operator (the raw diagonal
        # combined; hanging rows are outside the free masks)
        d_loc = jac.diagonal(dim1=0, dim2=1).T              # (ndl, c)
        du_r = scatter_add(cs.u, d_loc[:nud_l], jac.new_zeros(cs.n_ud))
        dp_r = scatter_add(cs.p, d_loc[nud_l:], jac.new_zeros(cs.n_p))
        du_r = pr["cb_u"](pr["ht_u"](du_r.reshape(free_u.shape)))
        dp_r = pr["cb_p"](pr["ht_p"](dp_r.reshape(free_p.shape)))
        Minv_u = torch.where(free_u & (du_r.abs() > 0), 1.0 / du_r, 1.0)
        Minv_p = torch.where(free_p & (dp_r.abs() > 0), 1.0 / dp_r, 1.0)

        def pdot(a, b):
            return _psum(part, a * b)

        def partials(*pairs):
            """(D_local, len(pairs)): each shard's sums of a * b."""
            return torch.stack([(a * b).reshape(a.shape[0], -1).sum(dim=1)
                                for a, b in pairs], dim=1)

        own = part.arrays.own_mask_p[..., None]
        ghost = part.arrays.is_ghost[..., None]

        def block_cg(op, gr, b, Minv, free, comps):
            """The block CG on the ghost read pg of the masked p.  An
            iteration meets the other shards three times: the matvec's
            combine, p . Ap, and one collective of r . z, the stop
            test's r . r (read from its host copy) and the owners'
            masked z, from which the next pg's ghost values follow by
            the z + beta p of their owners (the pool total of a ghost
            is its owner's value plus zeros: the same operands, the
            same bits as a ghost read of p)."""
            shape3 = (part.n_local, part.n_loc, comps)
            n_pools = (part.n_pool + 1) * comps
            z = Minv * b
            dev, host = psum_shards(partials((b, b), (b, z)), part.mesh,
                                    host=True)
            rz, bb = dev[0, 1], host[0]
            tol2 = max(rtol, 1e-14) ** 2 * bb
            x = torch.zeros_like(b)
            r, p, rr = b, z, bb
            pg = gr(torch.where(free, p, 0.0)).reshape(shape3)
            k = 0
            while k < HALO_CG_MAXITER and bool(rr > tol2):
                Ap = op(pg.reshape(p.shape))
                denom = pdot(p, Ap)
                alpha = torch.where(denom != 0, rz / denom, 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                z = Minv * r
                zm = torch.where(free, z, 0.0)
                pools = halo.write_pools(part, torch.where(
                    own, zm.reshape(shape3), 0.0)).reshape(part.n_local, -1)
                dev, host = psum_shards(
                    torch.cat([pools, partials((r, z), (r, r))], dim=1),
                    part.mesh, host=True)
                rz_new, rr = dev[0, n_pools], host[n_pools + 1]
                zg = halo.read_pools(part, dev[:, :n_pools].reshape(
                    part.n_local, part.n_pool + 1, comps))
                beta = torch.where(rz != 0, rz_new / rz, 0.0)
                p = z + beta * p
                pg = torch.where(ghost, zg + beta * pg,
                                 torch.where(free, p, 0.0).reshape(shape3))
                rz = rz_new
                k += 1
            return x, k

        bu = torch.where(free_u, rhs_u, 0.0)
        bp = torch.where(free_p, rhs_p, 0.0)
        du, it_u = block_cg(mv_u, pr["gr_u"], bu, Minv_u, free_u, dim)
        bp2 = bp - coupling_pu(du)
        dp, it_p = block_cg(mv_p, pr["gr_p"], bp2, Minv_p, free_p, 1)
        return du, dp, it_u + it_p, pdot(bp2, bp2), (it_u, it_p)

    return solve


# ---------------------------------------------------------------------------
# the outer PDAS loop
# ---------------------------------------------------------------------------

def newton_active_set_halo(sys, state, time: float, verbose: bool = True):
    """Sharded-DoF PDAS Newton on the owned+ghost pool.  Same contract
    as `newton.newton_active_set`: sets state.u/state.phi (flat, at the
    boundary), state.active_mask and state.last_log, and returns the
    last residual reduction.  The log also keeps the largest block-CG
    count of the solve (`max_block_iterations`)."""
    p = sys.params
    part: HaloPartition = sys.halo_partition
    with_split = sys.with_split
    log = NewtonLog()
    log.print_line("It.", "#A.Set", "#CycDoF", "Residual", "Reduction",
                   "LSrch", "#LinIts", verbose=verbose)
    initial_assemble, head, line_search = build_halo_heads(
        part, with_split=with_split,
        max_steps=max(1, p.max_no_line_search_steps))
    # JAX's build_halo_solver dispatches to its pooled Galerkin GMG when
    # a hierarchy is attached; its builder is a stub that attaches none
    solve = build_halo_cg(part, with_split=with_split)

    # boundary: flat state in, the inhomogeneous boundary values applied
    # flat (set_initial_bc, cracks.cc:2787), then scattered to the pool
    u_flat, phi_flat = sys.apply_initial_bc(state.u, state.phi, time)
    U = halo.global_to_local_u(part, u_flat)
    Ph = halo.global_to_local_p(part, phi_flat)
    P_old = halo.global_to_local_p(part, state.phi_old)
    P_oold = halo.global_to_local_p(part, state.phi_oold)
    con = sys.constraints(time)
    dir_u = halo.global_to_local_u(part, con.dirichlet_u.to(U.dtype)) > 0.5
    dir_p = halo.global_to_local_p(part, con.dirichlet_p.to(U.dtype)) > 0.5
    diag_mass = halo.global_to_local_p(part, sys.diag_mass.to(torch.float64))
    sc = sys.scalars

    tot_p, pde_u, pde_p, res0_d = initial_assemble(U, Ph, P_old, P_oold,
                                                   dir_u, dir_p, sc)
    newton_residual = float(res0_d)
    old_newton_residual = newton_residual
    log.print_line(0, "", "", f"{newton_residual:.6e}", verbose=verbose)

    active = torch.zeros_like(dir_p)
    # host-side, as in JAX: counts how often each slot LEFT the set
    cycle_counter = np.zeros(tuple(active.shape), np.int64)
    c_weight = 1e1 * p.E_modulus   # cracks.cc:2859
    n_cycling_threshold = 5        # cracks.cc:2866

    newton_step = 0
    sum_lin_it = 0
    max_block = 0
    new_newton_residual = 0.0
    while True:
        active_old = active
        cycling = torch.as_tensor(cycle_counter >= n_cycling_threshold,
                                  device=U.device)
        (Ph, active, tot_p, pde_u, pde_p, left), st = head(
            U, Ph, P_old, P_oold, tot_p, active_old, cycling, dir_u, dir_p,
            diag_mass, c_weight, sc)
        st = {k: v.item() for k, v in st.items()}
        cycle_counter[left.cpu().numpy()] += 1

        DU, DP, n_lin, _rr, blocks = solve(
            U, Ph, P_old, P_oold, active, dir_u, dir_p, pde_u, pde_p,
            p.cg_rtol, sc)
        sum_lin_it += n_lin
        max_block = max(max_block, *blocks)

        U, Ph, tot_p, pde_u, pde_p, new_newton_residual, line_search_step = \
            line_search(U, Ph, DU, DP, P_old, P_oold, active, dir_u, dir_p,
                        newton_residual, p.line_search_damping, sc)

        log.print_line(
            newton_step + 1, int(st["n_active"]), int(st["n_cycling"]),
            f"{new_newton_residual:.6e}",
            f"{new_newton_residual / newton_residual:.6e}",
            line_search_step, n_lin, verbose=verbose)

        old_newton_residual = newton_residual
        newton_residual = new_newton_residual
        newton_step += 1

        set_settled = st["changed"] == 0
        if not set_settled:
            in_band, ind_band = _flips_within_band(
                newton_step, st["ind_flip_max"], st["ind_act_max"],
                p.active_set_rel_tol, c_weight, float(sc.G_c),
                float(sc.alpha_eps))
            if in_band:
                set_settled = True
                log.print_line(
                    f"\tActive set settled: {int(st['changed'])} flips "
                    f"within complementarity band {ind_band:.3e} "
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

    # boundary: pooled state out -> flat driver state
    state.u = halo.local_to_global_u(part, U)
    state.phi = halo.local_to_global_p(part, Ph)
    state.active_mask = (halo.local_to_global_p(part, active.to(U.dtype))
                         > 0.5).cpu().numpy()
    log.newton_steps = newton_step
    log.linear_iterations = sum_lin_it
    log.active_set_size = int(state.active_mask.sum())
    log.max_block_iterations = max_block
    state.last_log = log
    return new_newton_residual / old_newton_residual
