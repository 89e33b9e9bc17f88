"""Atomic checkpoint save and restore of the simulation state.

Counterpart of ``tnl_lbm_tpu/sim/checkpoint.py`` (reference CheckpointManager
over ADIOS2, checkpoint.h:6-130; save/load flow state.hpp:677-781), in the
same file format, so that a run checkpointed by either package resumes in
the other:

- ``<dir>/checkpoint.npz`` holds one array per name and ``__meta__``, the
  JSON metadata as uint8 bytes;
- it is written to a temporary file and published by ``rename_exchange``
  (or, in the background, by the native writer's rename), so a reader sees
  the previous checkpoint or the new one, never a torn file;
- a checkpoint written by a sharded run of the JAX package keeps each
  device's blocks in ``checkpoint_shard{i:03d}_{epoch}.npz`` and their
  layout in the meta's ``__shards__``; :func:`load_checkpoint` reassembles
  them (numpy only) and raises for a shard of another epoch or parts that
  do not tile an array.

The port writes from one device: each tensor is copied to the host once
per save and the main file holds every array.  Sharded writing is ROADMAP
A13.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.io import native
from tnl_lbm_tpu_torch.utils.fileutils import mkdir_p, rename_exchange

CHECKPOINT = "checkpoint.npz"


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _shard_files(directory: Path, epoch) -> list:
    return list(directory.glob(f"checkpoint_shard???_{epoch}.npz"))


def save_checkpoint(directory, arrays: dict, meta: dict, background: bool = False) -> Path:
    """Save ``arrays`` (name -> tensor or array) and ``meta`` (JSON-able) as
    ``<directory>/checkpoint.npz``; returns its path.

    ``background=True`` serializes here and hands the bytes to the native
    writer (``io/native.py``), which publishes the file from its thread;
    call ``io.native.flush()`` before relying on it.  Otherwise the file is
    written and published before this returns.
    """
    directory = Path(directory)
    mkdir_p(directory)
    final = directory / CHECKPOINT
    prev_epoch = None
    if final.exists():
        try:
            with np.load(final) as old:
                if "__meta__" in old.files:
                    prev_epoch = json.loads(bytes(old["__meta__"]).decode()).get("__epoch__")
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            prev_epoch = None  # an unreadable old file is replaced all the same
    payload = {k: _host(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if background:
        buf = io.BytesIO()
        np.savez(buf, **payload)
        native.write_blob_async(final, buf.getvalue(), atomic=True)
    else:
        tmp = final.with_name(final.name + ".tmp")
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        rename_exchange(tmp, final)
    if prev_epoch is not None:
        # the superseded checkpoint was a sharded one: its blocks go once
        # the new main file, which references none of them, is on disk
        if background:
            native.flush()
        for p in _shard_files(directory, prev_epoch):
            p.unlink(missing_ok=True)
    return final


def load_checkpoint(directory):
    """``(arrays, meta)`` of ``<directory>/checkpoint.npz``, or None when
    there is none.  Arrays a sharded JAX run wrote per device are
    reassembled into whole host arrays; a shard file of another epoch, or
    parts that do not cover an array exactly, raise."""
    directory = Path(directory)
    final = directory / CHECKPOINT
    if not final.exists():
        return None
    with np.load(final) as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
        meta = json.loads(bytes(data["__meta__"]).decode())
    shard_meta = meta.pop("__shards__", None)
    epoch = meta.pop("__epoch__", None)
    if not shard_meta:
        return arrays, meta
    files = {}

    def open_shard(i):
        path = directory / (f"checkpoint_shard{i:03d}_{epoch}.npz" if epoch is not None
                            else f"checkpoint_shard{i:03d}.npz")
        if not path.exists() and epoch is not None:
            path = directory / f"checkpoint_shard{i:03d}.npz"  # the layout before epochs
        fh = np.load(path)
        tok = fh["__epoch__"] if "__epoch__" in fh.files else None
        if epoch is not None and tok is not None and int(tok) != int(epoch):
            fh.close()
            raise RuntimeError(f"torn checkpoint: {path.name} carries epoch {int(tok)} but "
                               f"{CHECKPOINT} expects {int(epoch)}")
        return fh

    try:
        for k, info in shard_meta.items():
            out = np.zeros(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
            covered = 0
            for i, idx in info["parts"]:
                if i not in files:
                    files[i] = open_shard(i)
                out[tuple(slice(s, e) for s, e in idx)] = files[i][k]
                covered += int(np.prod([e - s for s, e in idx]))
            if covered != out.size:
                raise RuntimeError(f"checkpoint array '{k}': shard parts cover {covered} of "
                                   f"{out.size} elements - refusing a partial resume")
            arrays[k] = out
    finally:
        for fh in files.values():
            fh.close()
    return arrays, meta
