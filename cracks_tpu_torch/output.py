"""VTU/PVD visualization output.

The port's copy of ``cracks_tpu/output.py`` (numpy only).

Minimal replacement for the reference's output_results + DataOut
(cracks.cc:3142-3258): one ASCII .vtu per output step with the
displacement vector, phase field, optional exact Sneddon phase field,
optional E-modulus cell field and the active-set mask, plus a
solution.pvd master record for ParaView.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import MeshData

# lexicographic -> VTK vertex order
_VTK_QUAD = [0, 1, 3, 2]
_VTK_HEX = [0, 1, 3, 2, 4, 5, 7, 6]


def write_vtu(path: str, mesh: MeshData, point_data: dict, cell_data: dict):
    dim = mesh.dim
    pts = mesh.vert_coords
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    conn = mesh.cell2vert[:, _VTK_QUAD if dim == 2 else _VTK_HEX]
    ctype = 9 if dim == 2 else 12
    nvc = conn.shape[1]

    def arr(a):
        return " ".join(f"{x:.10g}" for x in np.asarray(a).ravel())

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{len(pts)}" '
                f'NumberOfCells="{mesh.n_cells}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(arr(pts))
        f.write('\n</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        f.write(arr(conn))
        f.write('\n</DataArray>\n')
        f.write('<DataArray type="Int32" Name="offsets" format="ascii">\n')
        f.write(arr(np.arange(1, mesh.n_cells + 1) * nvc))
        f.write('\n</DataArray>\n')
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(arr(np.full(mesh.n_cells, ctype)))
        f.write('\n</DataArray>\n</Cells>\n<PointData>\n')
        for name, data in point_data.items():
            data = np.asarray(data)
            ncomp = 1 if data.ndim == 1 else data.shape[1]
            if ncomp == 2:  # pad vectors to 3 components for ParaView
                data = np.concatenate([data, np.zeros((len(data), 1))], axis=1)
                ncomp = 3
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write(arr(data))
            f.write('\n</DataArray>\n')
        f.write('</PointData>\n<CellData>\n')
        for name, data in cell_data.items():
            f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
            f.write(arr(data))
            f.write('\n</DataArray>\n')
        f.write('</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')


class PvdWriter:
    """Accumulates (time, vtu) records into ParaView .pvd and VisIt
    .visit master files (the reference writes solution.pvd and
    solution.visit, cracks.cc:3240-3256)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.records: list[tuple[float, str]] = []

    def add(self, time: float, vtu_name: str):
        self.records.append((time, vtu_name))
        path = os.path.join(self.directory, "solution.pvd")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                    'version="0.1">\n<Collection>\n')
            for t, name in self.records:
                f.write(f'<DataSet timestep="{t}" group="" part="0" '
                        f'file="{name}"/>\n')
            f.write('</Collection>\n</VTKFile>\n')
        with open(os.path.join(self.directory, "solution.visit"), "w") as f:
            for _, name in self.records:
                f.write(name + "\n")
