"""Minimal VTU (VTK XML unstructured grid) writer (host numpy).

Counterpart of ``dune_hdd_tpu/utils/vtk.py`` for the P1 triangle spaces the
port has: CG functions as point data on the shared mesh, DG functions on a
vertex-duplicated mesh (so inter-element jumps stay visible), indicator
fields as cell data.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_vtu", "write_cell_data_vtu"]

_VTK_TYPE = {"triangle": 5}


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
    """Write a discrete P1 function (a numpy array or a tensor on any
    device); returns the written path."""
    grid = space.grid
    values = np.asarray(dof_values.detach().cpu() if hasattr(dof_values, "detach")
                        else dof_values)
    if space.continuous:
        return _write(_vtu_xml(grid.vertices, grid.cells, grid.cell_type, {name: values}, {}),
                      filename)
    # duplicated-vertex mesh: point p of cell c is dof cell_dofs[c, p]
    nvc = grid.vertices_per_cell
    points = grid.cell_vertices.reshape(-1, 2)
    cells = np.arange(grid.num_cells * nvc).reshape(-1, nvc)
    return _write(_vtu_xml(points, cells, grid.cell_type,
                           {name: values[space.cell_dofs.ravel()]}, {}), filename)


def write_cell_data_vtu(grid, cell_values: dict, filename: str) -> str:
    """Write P0 / indicator fields as cell data."""
    return _write(_vtu_xml(grid.vertices, grid.cells, grid.cell_type, {},
                           {k: np.asarray(v) for k, v in cell_values.items()}), filename)
