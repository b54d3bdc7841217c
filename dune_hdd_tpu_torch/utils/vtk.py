"""Minimal VTU (VTK XML unstructured grid) writer (host numpy).

Counterpart of ``dune_hdd_tpu/utils/vtk.py``, with the same text: CG
functions as point data on the shared mesh, DG functions on a
vertex-duplicated mesh (so inter-element jumps stay visible), CG P2 on
triangles as quadratic triangles over the vertices and edge midpoints, the
other higher orders on duplicated nodal points, indicator fields as cell
data.  Values may be numpy arrays or tensors on any device; they come to
the host here, at the write.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_vtu", "write_cell_data_vtu"]

_VTK_TYPE = {"triangle": 5, "quad": 9, "triangle6": 22,
             "biquad_quad9": 28, "lagrange_tri10": 69}


def _host(values) -> np.ndarray:
    return np.asarray(values.detach().cpu() if hasattr(values, "detach") else values)


def _vtu_xml(points: np.ndarray, cells: np.ndarray, cell_type: str,
             point_data: dict, cell_data: dict) -> str:
    npts, ncells = len(points), len(cells)
    nvc = cells.shape[1]
    pts3 = np.column_stack([points, np.zeros(len(points))])
    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">',
        "<Points>",
        '<DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        " ".join(f"{v:.16g}" for v in pts3.ravel()),
        "</DataArray>",
        "</Points>",
        "<Cells>",
        '<DataArray type="Int64" Name="connectivity" format="ascii">',
        " ".join(str(i) for i in cells.ravel()),
        "</DataArray>",
        '<DataArray type="Int64" Name="offsets" format="ascii">',
        " ".join(str((i + 1) * nvc) for i in range(ncells)),
        "</DataArray>",
        '<DataArray type="UInt8" Name="types" format="ascii">',
        " ".join(str(_VTK_TYPE[cell_type]) for _ in range(ncells)),
        "</DataArray>",
        "</Cells>",
    ]
    for tag, data in (("PointData", point_data), ("CellData", cell_data)):
        if data:
            parts.append(f"<{tag}>")
            for name, vals in data.items():
                parts.append(f'<DataArray type="Float64" Name="{name}" format="ascii">')
                parts.append(" ".join(f"{v:.16g}" for v in np.asarray(vals).ravel()))
                parts.append("</DataArray>")
            parts.append(f"</{tag}>")
    parts += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    return "\n".join(parts)


def _write(xml: str, filename: str) -> str:
    if not filename.endswith(".vtu"):
        filename = filename + ".vtu"
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as fh:
        fh.write(xml)
    return filename


def write_vtu(space, dof_values, filename: str, name: str = "solution") -> str:
    """Write a discrete function; returns the written path."""
    grid = space.grid
    dof_values = _host(dof_values)
    order = getattr(space, "order", 1)
    if order == 2 and grid.cell_type == "triangle" and space.continuous:
        # VTK quadratic triangles (type 22): corner nodes, then the edge
        # midpoints (0-1), (1-2), (2-0): the P2 local order (v0, v1, v2,
        # e01, e12, e20)
        mids = 0.5 * (grid.vertices[grid.faces[:, 0]] + grid.vertices[grid.faces[:, 1]])
        points = np.concatenate([grid.vertices, mids])
        cells = np.concatenate([grid.cells, grid.num_vertices + grid.cell_faces],
                               axis=1).astype(np.int64)
        xml = _vtu_xml(points, cells, "triangle6", {name: dof_values}, {})
    elif order > 1:
        # duplicated nodal points per cell, whose orders match VTK's: P2
        # triangle -> 22, Q2 quad (corners, edges, centre) -> 28, P3 triangle
        # (vertices, 2 per edge along the edge, interior) -> Lagrange 69
        vtk_kind = {
            ("triangle", 2): "triangle6",
            ("quad", 2): "biquad_quad9",
            ("triangle", 3): "lagrange_tri10",
        }[(grid.cell_type, order)]
        nd = space.shape_count
        points = np.asarray(space.nodal_points).reshape(-1, 2)
        cells = np.arange(grid.num_cells * nd).reshape(-1, nd)
        xml = _vtu_xml(points, cells, vtk_kind, {name: dof_values[space.cell_dofs.ravel()]}, {})
    elif space.continuous:
        xml = _vtu_xml(grid.vertices, grid.cells, grid.cell_type, {name: dof_values}, {})
    else:
        # duplicated-vertex mesh: point p of cell c is dof cell_dofs[c, p]
        nvc = grid.vertices_per_cell
        points = grid.cell_vertices.reshape(-1, 2)
        cells = np.arange(grid.num_cells * nvc).reshape(-1, nvc)
        xml = _vtu_xml(points, cells, grid.cell_type,
                       {name: dof_values[space.cell_dofs.ravel()]}, {})
    return _write(xml, filename)


def write_cell_data_vtu(grid, cell_values: dict, filename: str) -> str:
    """Write P0 / indicator fields as cell data."""
    return _write(_vtu_xml(grid.vertices, grid.cells, grid.cell_type, {},
                           {k: _host(v) for k, v in cell_values.items()}), filename)
