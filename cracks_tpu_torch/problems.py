"""Problem library: initial phase-field cracks, Dirichlet boundary
conditions, and heterogeneous materials for the six built-in test cases.

Mirrors the reference's Function classes (cracks.cc:355-923) and
set_boundary_conditions (cracks.cc:2567-2697).  All functions are
vectorized over vertices.

Test cases (cracks.cc:1124-1128): sneddon, miehe tension, miehe shear,
multiple homo, multiple het, three point bending.
"""

from __future__ import annotations

import numpy as np

from .config import Parameters
from .mesh import MeshData


# ---------------------------------------------------------------------------
# initial values (cracks.cc:355-747)
# ---------------------------------------------------------------------------

def initial_values(p: Parameters, mesh: MeshData, min_cell_diameter: float):
    """Returns (u0 (n_v, dim), phi0 (n_v,)) nodal initial values."""
    x = mesh.vert_coords
    dim = mesh.dim
    n_v = mesh.n_vertices
    u0 = np.zeros((n_v, dim))
    case = p.test_case

    if case == "sneddon":
        # slit [-1,1] x (+-h): phi=0 inside (cracks.cc:380-406)
        l0 = 1.0
        thickness = 2.0 * min_cell_diameter
        if dim == 2:
            r2 = x[:, 0] ** 2
        else:
            r2 = x[:, 0] ** 2 + x[:, 2] ** 2
        inside = (r2 <= l0 * l0) & (np.abs(2.0 * x[:, 1]) <= thickness)
        phi0 = np.where(inside, 0.0, 1.0)
    elif case == "multiple homo":
        # Example 3: two cracks (cracks.cc:504-545)
        w = min_cell_diameter
        h = min_cell_diameter
        c1 = ((x[:, 0] >= 2.5 - w / 2) & (x[:, 0] <= 2.5 + w / 2)
              & (x[:, 1] >= 0.8) & (x[:, 1] <= 1.5))
        c2 = ((x[:, 0] >= 0.5) & (x[:, 0] <= 1.5)
              & (x[:, 1] >= 3.0 - h / 2) & (x[:, 1] <= 3.0 + h / 2))
        phi0 = np.where(c1 | c2, 0.0, 1.0)
    elif case == "multiple het":
        w = min_cell_diameter
        h = min_cell_diameter
        if dim == 3:
            # (cracks.cc:599-613)
            c1 = ((x[:, 0] >= 2.6 - w / 2) & (x[:, 0] <= 2.6 + w / 2)
                  & (x[:, 1] >= 3.8 - w / 2) & (x[:, 1] <= 5.5 + w / 2)
                  & (x[:, 2] >= 4.0 - w / 2) & (x[:, 2] <= 4.0 + w / 2))
            c2 = ((x[:, 0] >= 5.5 - w / 2) & (x[:, 0] <= 7.0 + w / 2)
                  & (x[:, 1] >= 4.0 - w / 2) & (x[:, 1] <= 4.0 + w / 2)
                  & (x[:, 2] >= 6.0 - w / 2) & (x[:, 2] <= 6.0 + w / 2))
        else:
            c1 = ((x[:, 0] >= 2.5 - w / 2) & (x[:, 0] <= 2.5 + w / 2)
                  & (x[:, 1] >= 0.8) & (x[:, 1] <= 1.5))
            c2 = ((x[:, 0] >= 0.5) & (x[:, 0] <= 1.5)
                  & (x[:, 1] >= 3.0 - h / 2) & (x[:, 1] <= 3.0 + h / 2))
        phi0 = np.where(c1 | c2, 0.0, 1.0)
    elif case in ("miehe tension", "miehe shear"):
        # phi == 1, crack modeled by the slit mesh (cracks.cc:679-693)
        phi0 = np.ones(n_v)
    elif case == "three point bending":
        phi0 = np.ones(n_v)  # InitialValuesNoCrack (cracks.cc:728-738)
    else:
        raise NotImplementedError(case)
    return u0, phi0


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions (cracks.cc:2567-2697)
# ---------------------------------------------------------------------------

def dirichlet_conditions(p: Parameters, mesh: MeshData, time: float,
                         initial_step: bool):
    """Build Dirichlet masks/values.

    Returns (mask_u (n_v, dim) bool, vals_u, mask_p (n_v,) bool, vals_p).
    Values are only meaningful where masks are True; for
    initial_step=False all values are zero (Newton update form).
    """
    dim = mesh.dim
    n_v = mesh.n_vertices
    x = mesh.vert_coords
    mask_u = np.zeros((n_v, dim), dtype=bool)
    vals_u = np.zeros((n_v, dim))
    mask_p = np.zeros(n_v, dtype=bool)
    vals_p = np.zeros(n_v)
    bv = mesh.boundary_vertices
    case = p.test_case

    def clamp(bid, comps, values=None):
        if bid not in bv:
            return
        vids = bv[bid]
        for c in comps:
            mask_u[vids, c] = True
            vals_u[vids, c] = 0.0 if values is None else values[c]

    if dim == 3:
        # all faces clamp all displacement components (cracks.cc:2686-2694)
        for b in range(6):
            clamp(b, range(dim))
        return mask_u, vals_u, mask_p, vals_p

    if case in ("sneddon", "multiple homo", "multiple het"):
        for b in range(4):
            clamp(b, range(dim))
    elif case == "miehe tension":
        # u_y = 0 on bottom (id 2); top (id 3): u_x = 0, u_y = t
        # (cracks.cc:2584-2598; BoundaryTensionTest cracks.cc:777-798)
        clamp(2, [1])
        uy = time * 1.0 if initial_step else 0.0
        clamp(3, [0, 1], values=[0.0, uy])
    elif case == "miehe shear":
        # (cracks.cc:2600-2624; BoundaryShearTest cracks.cc:837-858)
        clamp(0, [1])
        clamp(1, [1])
        clamp(2, [0, 1])
        ux = -time * 1.0 if initial_step else 0.0
        clamp(3, [0, 1], values=[ux, 0.0])
        clamp(4, [1])  # bottom lip of the slit
    elif case == "three point bending":
        # vertex pins (cracks.cc:2626-2680)
        eps = 1e-10
        left = (np.abs(x[:, 1]) < eps) & (np.abs(x[:, 0] + 4.0) < eps)
        right = (np.abs(x[:, 1]) < eps) & (np.abs(x[:, 0] - 4.0) < eps)
        mask_u[left | right, 1] = True
        mask_u[left, 0] = True
        mask_p[left | right] = True
        vals_p[left | right] = 1.0 if initial_step else 0.0
        mid = (np.abs(x[:, 0]) < eps) & (np.abs(x[:, 1] - 2.0) < eps)
        mask_u[mid, 1] = True
        vals_u[mid, 1] = (-1.0 * time) if initial_step else 0.0
    else:
        raise NotImplementedError(case)

    return mask_u, vals_u, mask_p, vals_p


def recolor_threepoint_boundaries(mesh_coarse):
    """Reassign boundary ids of the three-point bending mesh by face
    position (cracks.cc:1275-1302): faces at y=2 -> id 3, x=-4 -> 0,
    x=4 -> 1."""
    eps = 1e-10
    verts = mesh_coarse.vertices
    for key in list(mesh_coarse.boundary_ids):
        center = verts[list(key)].mean(axis=0)
        if abs(center[1] - 2.0) < eps:
            mesh_coarse.boundary_ids[key] = 3
        elif abs(center[0] + 4.0) < eps:
            mesh_coarse.boundary_ids[key] = 0
        elif abs(center[0] - 4.0) < eps:
            mesh_coarse.boundary_ids[key] = 1
    return mesh_coarse


# ---------------------------------------------------------------------------
# heterogeneous material (BitmapFile/BitmapFunction, cracks.cc:118-241)
# ---------------------------------------------------------------------------

class BitmapField:
    """PGM-backed scalar field with bilinear interpolation, mapped onto
    [x1,x2]x[y1,y2] with range [minvalue, maxvalue].

    Faithful port of the sampling conventions of BitmapFile
    (cracks.cc:137-207), including its xi/eta clamping quirk
    (min(max(v, 1), 0) evaluates to 0, making the interpolation
    piecewise constant on pixels — reproduced deliberately)."""

    def __init__(self, path: str, x1, x2, y1, y2, minvalue, maxvalue):
        with open(path, "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if not ln.lstrip().startswith(b"#")]
        data = b" ".join(lines).split()
        assert data[0] in (b"P2",), "only ASCII PGM supported"
        nx, ny = int(data[1]), int(data[2])
        # data[3] is maxval; pixel values normalized by 255 like the
        # reference (cracks.cc:163), regardless of the header maxval
        vals = np.array(data[4:4 + nx * ny], dtype=np.float64) / 255.0
        self.image = vals.reshape(ny, nx)
        self.nx, self.ny = nx, ny
        self.hx = 1.0 / (nx - 1)
        self.hy = 1.0 / (ny - 1)
        self.x1, self.x2, self.y1, self.y2 = x1, x2, y1, y2
        self.minvalue, self.maxvalue = minvalue, maxvalue

    def _get(self, x, y):
        """Raw [0,1]x[0,1] lookup (BitmapFile::get_value)."""
        ix = np.clip((x / self.hx).astype(int), 0, self.nx - 2)
        iy = np.clip((y / self.hy).astype(int), 0, self.ny - 2)
        # reference quirk (cracks.cc:197-198): min(max(t,1),0) == 0
        xi = np.zeros_like(x)
        eta = np.zeros_like(y)

        def pix(i, j):
            return self.image[self.ny - 1 - j, i]

        return ((1 - xi) * (1 - eta) * pix(ix, iy)
                + xi * (1 - eta) * pix(ix + 1, iy)
                + (1 - xi) * eta * pix(ix, iy + 1)
                + xi * eta * pix(ix + 1, iy + 1))

    def value(self, pts: np.ndarray) -> np.ndarray:
        """BitmapFunction::value (cracks.cc:220-235), vectorized.
        pts: (n, dim)."""
        x = (pts[:, 0] - self.x1) / (self.x2 - self.x1)
        y = (pts[:, 1] - self.y1) / (self.y2 - self.y1)
        lo, hi = self.minvalue, self.maxvalue
        if pts.shape[1] == 2:
            return lo + self._get(x, y) * (hi - lo)
        z = (pts[:, 2] - self.y1) / (self.y2 - self.y1)
        # np.fmod matches C fmod (sign of the dividend), cracks.cc:233
        return lo + (
            self._get(x / 10.0, (y - z) / 10.0)
            + 0.5 * self._get((x + y) / 2.0, (z + x) / 2.0)
            + 0.25 * self._get(np.fmod(z + x - y, 10.0), np.fmod(y + x, 10.0))
        ) * (hi - lo) / 2.25


def cell_lame_fields(p: Parameters, mesh: MeshData, bitmap: BitmapField | None):
    """Per-cell (lam, mu): constant, or bitmap-driven for multiple het
    (cracks.cc:2207-2216: E := bitmap(center) + 1)."""
    n_c = mesh.n_cells
    if p.test_case == "multiple het":
        assert bitmap is not None
        centers = mesh.cell_coords.mean(axis=1)
        E = bitmap.value(centers) + 1.0
        nu = p.poisson_ratio_nu
        mu = E / (2.0 * (1.0 + nu))
        lam = 2.0 * nu * mu / (1.0 - 2.0 * nu)
        return lam, mu
    mu0, lam0 = p.derived_lame
    return np.full(n_c, lam0), np.full(n_c, mu0)
