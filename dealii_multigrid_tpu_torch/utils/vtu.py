"""Minimal VTU (VTK XML unstructured grid) writer for solution output.

Mirror of the reference's Paraview output path (DataOut + write_vtu_in_parallel,
multigrid_throughput.cc:2359-2395): writes the active mesh as hexahedra with
the vertex values of the solution field.
"""

from __future__ import annotations

import numpy as np

from ..mesh.dof import DoFHandler

_VTK_HEX_CORNERS_3D = [
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]


def write_vtu(filename: str, dofh: DoFHandler, u: np.ndarray, name: str = "solution"):
    mesh = dofh.mesh
    if mesh.dim != 3:
        raise NotImplementedError("VTU writer is 3D")
    p = dofh.degree
    # vertex-local indices in VTK hexahedron corner order
    corner_locals = []
    for cx, cy, cz in _VTK_HEX_CORNERS_3D:
        corner_locals.append(int(cx * p + (p + 1) * (cy * p) + (p + 1) ** 2 * (cz * p)))
    corner_dofs = dofh.cell_dofs[:, corner_locals]            # [nc, 8]
    used, inverse = np.unique(corner_dofs.reshape(-1), return_inverse=True)
    pts = dofh.points[used]
    vals = np.asarray(u)[used]
    conn = inverse.reshape(-1, 8)
    nc = mesh.n_cells

    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write("<UnstructuredGrid>\n")
        f.write(f'<Piece NumberOfPoints="{len(pts)}" NumberOfCells="{nc}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        np.savetxt(f, pts, fmt="%.10g")
        f.write("</DataArray></Points>\n")
        f.write("<Cells>\n")
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        np.savetxt(f, conn, fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="Int64" Name="offsets" format="ascii">\n')
        np.savetxt(f, 8 * np.arange(1, nc + 1), fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full(nc, 12), fmt="%d")  # VTK_HEXAHEDRON
        f.write("</DataArray>\n")
        f.write("</Cells>\n")
        f.write(f'<PointData Scalars="{name}">\n')
        f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
        np.savetxt(f, vals, fmt="%.10g")
        f.write("</DataArray>\n")
        f.write("</PointData>\n")
        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
