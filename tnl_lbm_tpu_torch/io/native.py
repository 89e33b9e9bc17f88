"""ctypes bindings to the native background writer (``native/lbm_io.cpp``).

Counterpart of ``tnl_lbm_tpu/io/native.py``, bound to the same shared C++
source (the role of the reference's ADIOS2 engine thread,
adios_writer.hpp): checkpoint blobs and VTI payloads are handed to native
worker threads, so the simulation loop does not wait for the disk.

The library is built with ``g++`` at first use into ``build/torch_native/``
under the repository root, named by a hash of the source and flags, so an
edited source never loads a stale build.  A build that fails raises: a
caller that wants no native writer writes in the foreground itself
(``save_state(background=False)``).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "lbm_io.cpp"
BUILD_DIR = _REPO / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: background writer threads
THREADS = 2

_LIB: dict = {}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblbm_io_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``native/lbm_io.cpp`` if this source has no build yet; a
    failed build raises."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, lib.name)
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"building the native writer failed: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(f"building the native writer failed:\n{res.stderr[-2000:]}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


def get_lib():
    """The loaded library with its writer threads started (built at first use)."""
    if "lib" in _LIB:
        return _LIB["lib"]
    lib = ctypes.CDLL(str(build_library()))
    lib.lbm_io_init.argtypes = [ctypes.c_int]
    lib.lbm_io_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_int]
    lib.lbm_io_write_vti.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_int]
    lib.lbm_io_flush.argtypes = []
    lib.lbm_io_errors.argtypes = []
    lib.lbm_io_errors.restype = ctypes.c_uint64
    for fn in (lib.lbm_io_init, lib.lbm_io_write, lib.lbm_io_write_vti, lib.lbm_io_flush):
        fn.restype = None
    lib.lbm_io_init(THREADS)
    _LIB["lib"] = lib
    return lib


def loaded() -> bool:
    """True once the library is loaded (``flush``/``errors`` are then live)."""
    return "lib" in _LIB


def write_blob_async(path, data: bytes, atomic: bool = True) -> None:
    """Queue ``data`` for the writer threads: written to ``<path>.tmp`` and
    renamed into place when ``atomic``.  The bytes are copied before this
    returns; failures count in :func:`errors`."""
    lib = get_lib()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    lib.lbm_io_write(os.fspath(path).encode(), data, len(data), int(bool(atomic)))


def write_vti_async(path, header: bytes, footer: bytes, blobs, atomic: bool = True) -> None:
    """Queue a VTI file assembled natively: ``header``, each blob with its
    uint64 byte length before it (ParaView's raw appended data), ``footer``.
    The blobs are copied before this returns."""
    lib = get_lib()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arrs = [np.frombuffer(b, np.uint8) if isinstance(b, (bytes, bytearray))
            else np.ascontiguousarray(b) for b in blobs]
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    sizes = (ctypes.c_uint64 * len(arrs))(*[a.nbytes for a in arrs])
    lib.lbm_io_write_vti(os.fspath(path).encode(), header, len(header), footer, len(footer),
                         ptrs, sizes, len(arrs), int(bool(atomic)))


def flush() -> None:
    """Wait until every queued write is on disk (a no-op before the first
    write loaded the library)."""
    if loaded():
        _LIB["lib"].lbm_io_flush()


def errors() -> int:
    """Failed writes since the library was loaded."""
    return int(_LIB["lib"].lbm_io_errors()) if loaded() else 0
