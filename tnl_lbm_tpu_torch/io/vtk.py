"""VTK ImageData (.vti) writer (counterpart of ``tnl_lbm_tpu/io/vtk.py`` ``write_vti``).

One .vti per call with the fields as appended raw binary float32; the
caller places the grid (``origin`` from ``units.lbm2phys_point``, the
reference's lattice.h:63-66 convention).  The bytes equal the JAX
package's: same XML header, a little-endian uint64 length before each
blob, same footer.  The JAX writer hands the bytes to a native writer
thread; this one writes them synchronously, to a temporary file that is
renamed into place.

Scalars are numpy arrays shaped [X, Y(, Z)]; vectors [D, X, Y(, Z)] (padded
to 3 components).  Plane and sub-box cuts are made by slicing before writing.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np


def _as3d(shape):
    return tuple(shape) + (1,) * (3 - len(shape))


def write_vti(path, scalars: dict | None = None, vectors: dict | None = None,
              origin=(0.0, 0.0, 0.0), spacing: float = 1.0, start=(0, 0, 0)) -> None:
    """Write named point-data fields on an ImageData grid.

    ``origin`` is the physical position of the first site written,
    ``spacing`` the lattice spacing and ``start`` the global index of the
    first site (the WholeExtent offset of a cut).
    """
    scalars = scalars or {}
    vectors = vectors or {}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if scalars:
        sshape = next(iter(scalars.values())).shape
    elif vectors:
        sshape = next(iter(vectors.values())).shape[1:]
    else:
        raise ValueError("no fields given")
    nx, ny, nz = _as3d(sshape)
    x0, y0, z0 = _as3d(tuple(start))
    ext = f"{x0} {x0 + nx - 1} {y0} {y0 + ny - 1} {z0} {z0 + nz - 1}"

    blobs, arrays_xml = [], []
    offset = 0

    def add(name, data, comp):
        nonlocal offset
        raw = data.tobytes()
        blobs.append(raw)
        arrays_xml.append(
            f'<DataArray type="Float32" Name="{name}" NumberOfComponents="{comp}" '
            f'format="appended" offset="{offset}"/>')
        offset += 8 + len(raw)

    for name, arr in scalars.items():
        a = np.asarray(arr, dtype=np.float32).reshape(_as3d(np.shape(arr)))
        # VTK expects x fastest; the arrays are C-order [X, Y, Z]
        add(name, np.ascontiguousarray(a.transpose(2, 1, 0)), 1)
    for name, arr in vectors.items():
        a = np.asarray(arr, dtype=np.float32)
        d = a.shape[0]
        v = np.zeros((3,) + _as3d(a.shape[1:]), np.float32)
        v[:d] = a.reshape((d,) + _as3d(a.shape[1:]))
        add(name, np.ascontiguousarray(v.transpose(3, 2, 1, 0)), 3)

    o = _as3d(tuple(origin))
    header = f"""<?xml version="1.0"?>
<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" header_type="UInt64">
  <ImageData WholeExtent="{ext}" Origin="{o[0]} {o[1]} {o[2]}" Spacing="{spacing} {spacing} {spacing}">
    <Piece Extent="{ext}">
      <PointData>
        {'        '.join(arrays_xml)}
      </PointData>
      <CellData/>
    </Piece>
  </ImageData>
  <AppendedData encoding="raw">
   _"""
    footer = b"\n  </AppendedData>\n</VTKFile>\n"
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(header.encode())
        for raw in blobs:
            fh.write(struct.pack("<Q", len(raw)))
            fh.write(raw)
        fh.write(footer)
    os.replace(tmp, path)


def write_points_vtk(path, points: np.ndarray, time: float | None = None) -> None:
    """Legacy VTK POLYDATA point cloud (reference vtk_writer.h:5-48); the
    JAX package's ``write_points_vtk`` byte for byte."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n")
        fh.write(f"time {time}\n" if time is not None else "points\n")
        fh.write("ASCII\nDATASET POLYDATA\n")
        fh.write(f"POINTS {len(pts)} double\n")
        for p in pts:
            fh.write(f"{p[0]} {p[1]} {p[2]}\n")
