"""Cycle-append .vti time series with a ParaView ``.pvd`` index
(counterpart of ``tnl_lbm_tpu/io/series.py``).

Every ``append`` writes one ``.vti`` snapshot (``io/vtk.py``) and
republishes the ``.pvd`` collection that names every cycle with its
physical time, by atomic rename, so a reader never sees a torn index - the
analog of the reference's per-variable ADIOS2 append streams
(adios_writer.hpp:18-24).  A writer adopts the entries of an existing
index, so a resumed run keeps appending to the same stream.
"""

from __future__ import annotations

from pathlib import Path
from xml.sax.saxutils import quoteattr

from tnl_lbm_tpu_torch.io.vtk import write_vti
from tnl_lbm_tpu_torch.utils.fileutils import rename_exchange


class VtiTimeSeries:
    """Append-mode ImageData series with an atomic ``.pvd`` index."""

    def __init__(self, directory, name: str = "data"):
        self.directory = Path(directory)
        self.name = name
        self.index_path = self.directory / f"{name}.pvd"
        self.entries: list[tuple[float, str]] = []
        if self.index_path.exists():
            self._adopt_existing()

    def _adopt_existing(self):
        """Parse a previous run's index (resume = reopen in append mode)."""
        import xml.etree.ElementTree as ET

        try:
            root = ET.parse(self.index_path).getroot()
        except ET.ParseError:
            return
        for ds in root.iter("DataSet"):
            f = ds.get("file")
            if f:
                self.entries.append((float(ds.get("timestep", "0")), f))

    def append(self, scalars=None, vectors=None, *, time: float, origin=(0.0, 0.0, 0.0),
               spacing: float = 1.0, start=(0, 0, 0), cycle: int | None = None) -> Path:
        """Write one snapshot and republish the index; returns its path."""
        cycle = len(self.entries) if cycle is None else cycle
        fname = f"{self.name}_{cycle:06d}.vti"
        write_vti(self.directory / fname, scalars=scalars, vectors=vectors, origin=origin,
                  spacing=spacing, start=start)
        self.record(time=time, fname=fname)
        return self.directory / fname

    def record(self, *, time: float, fname: str) -> None:
        """Index a snapshot (a resumed run may rewrite the cycle it was saved at)."""
        self.entries = [(t, f) for t, f in self.entries if f != fname]
        self.entries.append((float(time), fname))
        self._publish_index()

    def _publish_index(self):
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
            " <Collection>",
        ]
        for t, f in self.entries:
            lines.append(f'  <DataSet timestep="{t:.12g}" group="" part="0" file={quoteattr(f)}/>')
        lines += [" </Collection>", "</VTKFile>", ""]
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.index_path.with_name(self.index_path.name + ".tmp")
        tmp.write_text("\n".join(lines))
        rename_exchange(tmp, self.index_path)
