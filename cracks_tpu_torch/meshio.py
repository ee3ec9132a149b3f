"""Coarse (root) mesh construction: generated rectangles, UCD .inp and
gmsh .msh readers.

Mirrors the reference's mesh DSL (reference cracks.cc:1194-1303,
``setup_mesh``): ``rect x0 y0 x1 y1`` generated grids with colorized
boundary ids, plus UCD and gmsh imports for the shipped mesh files
(meshes/unit_slit.inp, unit_square_4.inp, unit_cube_10.inp,
threepoint.msh).

Vertex ordering convention: cells store vertex indices in *lexicographic*
order (x fastest): 2D (v00, v10, v01, v11); 3D adds the z=1 layer.
UCD/gmsh files use counterclockwise ordering, which we convert.

Coincident-but-distinct vertices (the slit in unit_slit.inp: two vertices
at (1, 0.5)) are preserved: vertex identity is by index, never by
position.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# the shipped coarse meshes (meshes/ at the repository root)
MESH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "meshes")


@dataclass
class CoarseMesh:
    dim: int
    vertices: np.ndarray          # (n_vertices, dim) float64
    cells: np.ndarray             # (n_cells, 2**dim) int64, lexicographic order
    # boundary face -> boundary id; key = tuple(sorted(vertex ids of face))
    boundary_ids: dict = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)


# ---------------------------------------------------------------------------
# Face enumeration (lexicographic reference cell)
# ---------------------------------------------------------------------------
# Local vertex indices of the faces of the reference cell, in deal.II face
# order: face 2*d is the low side in direction d, face 2*d+1 the high side.
# 2D cell (lex order): 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
FACE_VERTICES_2D = [
    (0, 2),  # x = 0 (left)
    (1, 3),  # x = 1 (right)
    (0, 1),  # y = 0 (bottom)
    (2, 3),  # y = 1 (top)
]
# 3D cell: 0=(0,0,0) 1=(1,0,0) 2=(0,1,0) 3=(1,1,0) 4..7 the z=1 layer
FACE_VERTICES_3D = [
    (0, 2, 4, 6),  # x = 0
    (1, 3, 5, 7),  # x = 1
    (0, 1, 4, 5),  # y = 0
    (2, 3, 6, 7),  # y = 1
    (0, 1, 2, 3),  # z = 0
    (4, 5, 6, 7),  # z = 1
]


def face_vertices(dim: int):
    return FACE_VERTICES_2D if dim == 2 else FACE_VERTICES_3D


def fix_cell_orientation(mesh: "CoarseMesh") -> "CoarseMesh":
    """Reorient inverted cells (negative Jacobian at the cell center) by
    mirroring the local x axis — the job deal.II's GridIn does when
    reading meshes with inconsistent orientation (threepoint.msh stores
    clockwise quads)."""
    dim = mesh.dim
    cells = mesh.cells
    X = mesh.vertices[cells]  # (n, 2**dim, dim)
    if dim == 2:
        e1 = 0.5 * (X[:, 1] - X[:, 0] + X[:, 3] - X[:, 2])
        e2 = 0.5 * (X[:, 2] - X[:, 0] + X[:, 3] - X[:, 1])
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        flip = det < 0
        if flip.any():
            # mirror the local x axis: swap lex columns (0,1) and (2,3)
            cells = cells.copy()
            cells[flip] = cells[flip][:, [1, 0, 3, 2]]
    else:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        e3 = X[:, 4] - X[:, 0]
        det = np.einsum("nd,nd->n", np.cross(e1, e2), e3)
        flip = det < 0
        if flip.any():
            cells = cells.copy()
            cells[flip] = cells[flip][:, [1, 0, 3, 2, 5, 4, 7, 6]]
    mesh.cells = cells
    return mesh


# ---------------------------------------------------------------------------
# Generated rectangle (reference cracks.cc:1240-1254)
# ---------------------------------------------------------------------------

def rect_mesh(p1, p2, repetitions=None, colorize: bool = True) -> CoarseMesh:
    """Subdivided hyper-rectangle with `repetitions` cells per direction
    (default 10, as in the reference) and colorized boundary ids:
    2*d = low side in direction d, 2*d+1 = high side."""
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    dim = len(p1)
    if repetitions is None:
        repetitions = [10] * dim
    reps = list(repetitions)

    axes = [np.linspace(p1[d], p2[d], reps[d] + 1) for d in range(dim)]
    if dim == 2:
        X, Y = np.meshgrid(axes[0], axes[1], indexing="ij")
        verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)
        nx = reps[0] + 1

        def vid(i, j):
            return j * nx + i

        cells = []
        for j in range(reps[1]):
            for i in range(reps[0]):
                cells.append([vid(i, j), vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)])
        cells = np.array(cells, dtype=np.int64)
        mesh = CoarseMesh(2, verts, cells)
        if colorize:
            for j in range(reps[1]):
                mesh.boundary_ids[tuple(sorted((vid(0, j), vid(0, j + 1))))] = 0
                mesh.boundary_ids[tuple(sorted((vid(reps[0], j), vid(reps[0], j + 1))))] = 1
            for i in range(reps[0]):
                mesh.boundary_ids[tuple(sorted((vid(i, 0), vid(i + 1, 0))))] = 2
                mesh.boundary_ids[tuple(sorted((vid(i, reps[1]), vid(i + 1, reps[1]))))] = 3
        return mesh

    # dim == 3
    nx, ny, nz = reps[0] + 1, reps[1] + 1, reps[2] + 1
    verts = np.zeros((nx * ny * nz, 3), dtype=np.float64)

    def vid3(i, j, k):
        return (k * ny + j) * nx + i

    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                verts[vid3(i, j, k)] = (axes[0][i], axes[1][j], axes[2][k])
    cells = []
    for k in range(reps[2]):
        for j in range(reps[1]):
            for i in range(reps[0]):
                cells.append([
                    vid3(i, j, k), vid3(i + 1, j, k), vid3(i, j + 1, k), vid3(i + 1, j + 1, k),
                    vid3(i, j, k + 1), vid3(i + 1, j, k + 1), vid3(i, j + 1, k + 1),
                    vid3(i + 1, j + 1, k + 1),
                ])
    cells = np.array(cells, dtype=np.int64)
    mesh = CoarseMesh(3, verts, cells)
    if colorize:
        for k in range(reps[2]):
            for j in range(reps[1]):
                q = (vid3(0, j, k), vid3(0, j + 1, k), vid3(0, j, k + 1), vid3(0, j + 1, k + 1))
                mesh.boundary_ids[tuple(sorted(q))] = 0
                q = (vid3(reps[0], j, k), vid3(reps[0], j + 1, k),
                     vid3(reps[0], j, k + 1), vid3(reps[0], j + 1, k + 1))
                mesh.boundary_ids[tuple(sorted(q))] = 1
        for k in range(reps[2]):
            for i in range(reps[0]):
                q = (vid3(i, 0, k), vid3(i + 1, 0, k), vid3(i, 0, k + 1), vid3(i + 1, 0, k + 1))
                mesh.boundary_ids[tuple(sorted(q))] = 2
                q = (vid3(i, reps[1], k), vid3(i + 1, reps[1], k),
                     vid3(i, reps[1], k + 1), vid3(i + 1, reps[1], k + 1))
                mesh.boundary_ids[tuple(sorted(q))] = 3
        for j in range(reps[1]):
            for i in range(reps[0]):
                q = (vid3(i, j, 0), vid3(i + 1, j, 0), vid3(i, j + 1, 0), vid3(i + 1, j + 1, 0))
                mesh.boundary_ids[tuple(sorted(q))] = 4
                q = (vid3(i, j, reps[2]), vid3(i + 1, j, reps[2]),
                     vid3(i, j + 1, reps[2]), vid3(i + 1, j + 1, reps[2]))
                mesh.boundary_ids[tuple(sorted(q))] = 5
    return mesh


# ---------------------------------------------------------------------------
# UCD (.inp) reader
# ---------------------------------------------------------------------------

def _ccw_quad_to_lex(v):
    # counterclockwise (a,b,c,d) -> lexicographic (a,b,d,c)
    return [v[0], v[1], v[3], v[2]]


def _ucd_hex_to_lex(v):
    # UCD hex: bottom face ccw then top face ccw
    return [v[0], v[1], v[3], v[2], v[4], v[5], v[7], v[6]]


def read_ucd(path: str, dim: int) -> CoarseMesh:
    """Read an AVS UCD .inp file (format of deal.II GridIn::ucd)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_vertices = int(next(it))
    n_elements = int(next(it))
    next(it); next(it); next(it)  # counts of data fields, unused

    vert_index: dict[int, int] = {}
    verts = np.zeros((n_vertices, dim), dtype=np.float64)
    for i in range(n_vertices):
        label = int(next(it))
        coords = [float(next(it)) for _ in range(3)]
        vert_index[label] = i
        verts[i] = coords[:dim]

    cells = []
    boundary_ids: dict = {}
    for _ in range(n_elements):
        next(it)  # element label
        material = int(next(it))
        kind = next(it)
        if kind == "quad":
            v = [vert_index[int(next(it))] for _ in range(4)]
            if dim == 2:
                cells.append(_ccw_quad_to_lex(v))
            else:
                boundary_ids[tuple(sorted(v))] = material
        elif kind == "hex":
            v = [vert_index[int(next(it))] for _ in range(8)]
            cells.append(_ucd_hex_to_lex(v))
        elif kind == "line":
            v = [vert_index[int(next(it))] for _ in range(2)]
            if dim == 2:
                boundary_ids[tuple(sorted(v))] = material
        else:
            raise ValueError(f"unsupported UCD element type {kind!r}")

    return fix_cell_orientation(
        CoarseMesh(dim, verts, np.array(cells, dtype=np.int64), boundary_ids))


# ---------------------------------------------------------------------------
# gmsh 2.2 (.msh) reader
# ---------------------------------------------------------------------------

def read_msh(path: str, dim: int = 2) -> CoarseMesh:
    """Read a gmsh ASCII v2.2 mesh (quads + boundary lines), as used by
    meshes/threepoint.msh."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i] != tag:
            i += 1
        if i == len(lines):
            raise ValueError(f"section {tag} not found in {path}")
        i += 1

    seek("$Nodes")
    n_nodes = int(lines[i]); i += 1
    vert_index: dict[int, int] = {}
    verts = np.zeros((n_nodes, dim), dtype=np.float64)
    for n in range(n_nodes):
        parts = lines[i].split(); i += 1
        vert_index[int(parts[0])] = n
        verts[n] = [float(x) for x in parts[1:1 + dim]]

    seek("$Elements")
    n_elem = int(lines[i]); i += 1
    cells = []
    boundary_ids: dict = {}
    for _ in range(n_elem):
        parts = lines[i].split(); i += 1
        etype = int(parts[1])
        ntags = int(parts[2])
        tags = [int(t) for t in parts[3:3 + ntags]]
        nodes = [vert_index[int(v)] for v in parts[3 + ntags:]]
        physical = tags[0] if tags else 0
        if etype == 3:  # 4-node quad
            cells.append(_ccw_quad_to_lex(nodes))
        elif etype == 1:  # 2-node line -> boundary id from physical tag
            boundary_ids[tuple(sorted(nodes))] = physical
        elif etype == 15:  # point
            continue
        else:
            raise ValueError(f"unsupported gmsh element type {etype}")

    return fix_cell_orientation(
        CoarseMesh(dim, verts, np.array(cells, dtype=np.int64), boundary_ids))
