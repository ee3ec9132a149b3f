"""Spectral-window policy of the lattice GMG smoother.

Port of ``sharp_spectrum``/``smoothing_range`` from
``cracks_tpu/solvers/multigrid.py``.  Production sizes get the sharp
window (Lanczos lambda_max, Chebyshev smoothing range 4); golden sizes
keep the Gershgorin bound with range 20, which tracks the reference's
PDAS basin digit for digit (see the JAX module for the measured
ladder).
"""

from __future__ import annotations

SHARP_SPECTRUM_MIN_DOFS = 50_000
SHARP_RANGE = 4.0
GERSHGORIN_RANGE = 20.0


def sharp_spectrum(n_dofs: int) -> bool:
    return n_dofs > SHARP_SPECTRUM_MIN_DOFS


def smoothing_range(sharp: bool) -> float:
    return SHARP_RANGE if sharp else GERSHGORIN_RANGE
