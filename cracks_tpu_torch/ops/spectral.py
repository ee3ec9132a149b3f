"""Closed-form 2x2 symmetric eigendecomposition and the Miehe tensile/
compressive stress split, as differentiable torch code.

Port of ``cracks_tpu/ops/spectral.py`` (reference cracks.cc:1691-1737,
``eigen_vectors_and_values``, and cracks.cc:1923-2120,
``decompose_stress``).  The linearization is the forward-mode derivative
(``torch.func.jvp``) of the primal formulas, which equals the
reference's hand-written directional derivative.  Every non-smooth gate
is a ``torch.where``, never ``clamp``/``relu``/``maximum``, so that the
tangent is the selected branch's, as ``jnp.where``'s is, ties included:

 * positive-part eigenvalues:  lambda+ = where(lambda < 0, 0, lambda)
   with tangent where(lambda < 0, 0, dlambda)   (cracks.cc:2068-2081)
 * positive-part trace:        tr+ = where(tr < 0, 0, tr)
   with tangent where(tr < 0, 0, dtr)           (cracks.cc:2094-2101)

(``clamp_min``'s tangent at 0 and ``maximum``'s half-split at ties are
not these.)  At an isotropic strain the square root sits at 0 and its
tangent is not finite; the degenerate gate selects the isotropic branch
there, and that non-finite tangent only ever enters the branch the gate
drops, never a product or a sum outside it.

Vectorized over arbitrary leading batch dimensions; the split is
defined for dim == 2 only, as in the reference.
"""

from __future__ import annotations

import torch


def eigen_2x2_sym(E):
    """Eigenvalues and eigenvector matrix of symmetric 2x2 tensors.

    E: (..., 2, 2).  Returns (lam1, lam2, P) with P[..., :, 0] the first
    eigenvector, with the reference's branch structure and normalization
    (cracks.cc:1691-1737)."""
    a = E[..., 0, 0]
    b = E[..., 0, 1]
    c = E[..., 1, 1]

    # '<=' where the reference has '<' (cracks.cc:1700-1701): the same
    # wherever the reference is finite, and E = 0 takes the (exact)
    # diagonal branch instead of dividing by zero
    near_diag = ((b.abs() <= 1e-10 * a.abs())
                 | (b.abs() <= 1e-10 * c.abs()))
    b_safe = torch.where(near_diag, 1.0, b)

    sq = torch.sqrt((a - c) * (a - c) + 4.0 * b_safe * b_safe)
    lam1_g = 0.5 * ((a + c) + sq)
    lam2_g = 0.5 * ((a + c) - sq)

    r1 = (lam1_g - a) / b_safe
    r2 = (lam2_g - a) / b_safe
    n1 = 1.0 / torch.sqrt(1.0 + r1 * r1)
    n2 = 1.0 / torch.sqrt(1.0 + r2 * r2)

    lam1 = torch.where(near_diag, a, lam1_g)
    lam2 = torch.where(near_diag, c, lam2_g)

    v1x = torch.where(near_diag, 1.0, n1)
    v1y = torch.where(near_diag, 0.0, n1 * r1)
    v2x = torch.where(near_diag, 0.0, n2)
    v2y = torch.where(near_diag, 1.0, n2 * r2)

    P = torch.stack([torch.stack([v1x, v2x], dim=-1),
                     torch.stack([v1y, v2y], dim=-1)], dim=-2)
    return lam1, lam2, P


def stress_split_components(exx, exy, eyy, lam_coeff, mu_coeff):
    """Component form of the Miehe split on same-shaped (or
    broadcastable) strain component tensors; the element residual's
    form.  Returns ((sp_xx, sp_xy, sp_yy), (sm_xx, sm_xy, sm_yy)).  See
    stress_split_2d for the math."""
    a, b, c = exx, exy, eyy
    trE = a + c
    sq = torch.sqrt((a - c) * (a - c) + 4.0 * b * b)   # l1 - l2 >= 0
    l1 = 0.5 * (trE + sq)
    l2 = 0.5 * (trE - sq)
    l1p = torch.where(l1 < 0.0, 0.0, l1)
    l2p = torch.where(l2 < 0.0, 0.0, l2)

    scale = a.abs() + c.abs() + 2.0 * b.abs()
    degenerate = sq <= 1e-12 * scale
    inv_sq = 1.0 / torch.where(degenerate, 1.0, sq)

    # spectral projections P1 = (E - l2 I)/sq, P2 = (l1 I - E)/sq
    ep_xx_g = (l1p * (a - l2) + l2p * (l1 - a)) * inv_sq
    ep_yy_g = (l1p * (c - l2) + l2p * (l1 - c)) * inv_sq
    ep_xy_g = (l1p - l2p) * b * inv_sq
    # isotropic limit: E+ = E if tr >= 0 else 0
    pos = trE >= 0.0
    ep_xx = torch.where(degenerate, torch.where(pos, a, 0.0), ep_xx_g)
    ep_yy = torch.where(degenerate, torch.where(pos, c, 0.0), ep_yy_g)
    ep_xy = torch.where(degenerate, torch.where(pos, b, 0.0), ep_xy_g)

    trp = torch.where(trE < 0.0, 0.0, trE)
    lam = lam_coeff
    mu = mu_coeff
    sp_xx = lam * trp + 2.0 * mu * ep_xx
    sp_yy = lam * trp + 2.0 * mu * ep_yy
    sp_xy = 2.0 * mu * ep_xy
    sm_xx = lam * (trE - trp) + 2.0 * mu * (a - ep_xx)
    sm_yy = lam * (trE - trp) + 2.0 * mu * (c - ep_yy)
    sm_xy = 2.0 * mu * (b - ep_xy)
    return (sp_xx, sp_xy, sp_yy), (sm_xx, sm_xy, sm_yy)


def _coeff(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def stress_split_2d(E, lam_coeff, mu_coeff):
    """Miehe spectral split of the linear-elastic stress into tensile and
    compressive parts (cracks.cc:1959-1970):

        sigma+ = lambda tr+(E) I + 2 mu E+
        sigma- = lambda (tr E - tr+(E)) I + 2 mu (E - E+)

    E: (..., 2, 2) symmetric strains; lam_coeff/mu_coeff broadcastable
    scalars or (...,) tensors.  Returns (sigma_plus, sigma_minus).

    E+ is built from the spectral projections P_i = ±(E - lambda_j I)/
    (l1 - l2), not from eigenvectors: the same values, and a derivative
    that keeps the shear sensitivity at near-diagonal strains.  At
    (near-)isotropic strains E+ is E (tr E >= 0) or 0."""
    a = E[..., 0, 0]
    b = E[..., 0, 1]
    c = E[..., 1, 1]
    trE = a + c
    sq = torch.sqrt((a - c) * (a - c) + 4.0 * b * b)   # l1 - l2 >= 0
    l1 = 0.5 * (trE + sq)
    l2 = 0.5 * (trE - sq)
    l1p = torch.where(l1 < 0.0, 0.0, l1)
    l2p = torch.where(l2 < 0.0, 0.0, l2)

    scale = a.abs() + c.abs() + 2.0 * b.abs()
    degenerate = sq <= 1e-12 * scale
    sq_safe = torch.where(degenerate, 1.0, sq)

    eye = torch.eye(2, dtype=E.dtype, device=E.device)
    P1 = (E - l2[..., None, None] * eye) / sq_safe[..., None, None]
    P2 = (l1[..., None, None] * eye - E) / sq_safe[..., None, None]
    Ep_gen = l1p[..., None, None] * P1 + l2p[..., None, None] * P2
    Ep_iso = torch.where((trE < 0.0)[..., None, None], torch.zeros_like(E), E)
    Ep = torch.where(degenerate[..., None, None], Ep_iso, Ep_gen)

    trp = torch.where(trE < 0.0, 0.0, trE)
    lam_b = _coeff(lam_coeff, E)[..., None, None]
    mu_b = _coeff(mu_coeff, E)[..., None, None]
    sp = lam_b * trp[..., None, None] * eye + 2.0 * mu_b * Ep
    sm = (lam_b * (trE - trp)[..., None, None] * eye
          + 2.0 * mu_b * (E - Ep))
    return sp, sm


def full_stress(E, lam_coeff, mu_coeff):
    """Plain linear-elastic stress lambda tr(E) I + 2 mu E, any dim."""
    dim = E.shape[-1]
    trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(dim, dtype=E.dtype, device=E.device)
    lam_b = _coeff(lam_coeff, E)[..., None, None]
    mu_b = _coeff(mu_coeff, E)[..., None, None]
    return lam_b * trE[..., None, None] * eye + 2.0 * mu_b * E
