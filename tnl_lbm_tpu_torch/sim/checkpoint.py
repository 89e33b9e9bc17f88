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
- a sharded array (a ``parallel.sharded.ShardedField``, as a run under a
  plan holds its state and statistics) is written per shard, as the JAX
  package writes each device's blocks: ``checkpoint_shard{i:03d}_{epoch}.npz``
  (``i`` the shard, the file's ``__epoch__`` the save's) with the layout in
  the meta's ``__shards__`` (shape, dtype and each shard's part, its
  index ranges in the whole array); the shard files are on disk before the
  main file that references them is published, and the superseded epoch's
  go after it.  :func:`load_checkpoint` reassembles such arrays, the JAX
  package's too (numpy only), and raises for a shard of another epoch or
  parts that do not tile an array, so a sharded checkpoint of either
  package resumes sharded or on one device in either.

Every other tensor is copied to the host once per save into the main file.
"""

from __future__ import annotations

import io
import json
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.io import native
from tnl_lbm_tpu_torch.parallel.sharded import ShardedField
from tnl_lbm_tpu_torch.utils.fileutils import mkdir_p, rename_exchange

CHECKPOINT = "checkpoint.npz"


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _shard_files(directory: Path, epoch) -> list:
    return list(directory.glob(f"checkpoint_shard???_{epoch}.npz"))


def _shard_parts(v: ShardedField):
    """(shard, index ranges in the whole array, host block) of each shard
    that holds part of ``v``'s true extent (a ghost-only block of an uneven
    plan holds none)."""
    local = tuple(p // n for p, n in zip(v.padded, v.plan.counts))
    true = v.shape[v.lead:]
    for k, b in enumerate(v.blocks):
        ranges = [(0, n) for n in v.shape[: v.lead]]
        for i, L, n in zip(v.plan.block_index(k), local, true):
            ranges.append((i * L, min((i + 1) * L, n)))
        if any(e <= s for s, e in ranges):
            continue
        part = b[tuple(slice(0, e - s) for s, e in ranges)]
        yield k, ranges, part.detach().cpu().numpy()


def _write(path: Path, payload: dict, background: bool) -> None:
    """One .npz, published atomically (by the native writer's rename in
    the background)."""
    if background:
        buf = io.BytesIO()
        np.savez(buf, **payload)
        native.write_blob_async(path, buf.getvalue(), atomic=True)
        return
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    rename_exchange(tmp, path)


def save_checkpoint(directory, arrays: dict, meta: dict, background: bool = False) -> Path:
    """Save ``arrays`` (name -> tensor, array or ShardedField) and ``meta``
    (JSON-able) as ``<directory>/checkpoint.npz``, a ShardedField per shard
    in its epoch's shard files; returns the main file's path.

    ``background=True`` serializes here and hands the bytes to the native
    writer (``io/native.py``), which publishes the files from its thread;
    call ``io.native.flush()`` before relying on them.  Otherwise the files
    are written and published before this returns.
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
    sharded = {k: v for k, v in arrays.items() if isinstance(v, ShardedField)}
    payload = {k: _host(v) for k, v in arrays.items() if k not in sharded}
    if sharded:
        epoch = time.time_ns()
        files, layout = {}, {}
        for k, v in sharded.items():
            parts = []
            for i, ranges, block in _shard_parts(v):
                files.setdefault(i, {})[k] = block
                parts.append([i, [list(r) for r in ranges]])
            layout[k] = {"shape": list(v.shape), "dtype": str(block.dtype), "parts": parts}
        for i, part in files.items():
            part["__epoch__"] = np.asarray(epoch, np.int64)
            _write(directory / f"checkpoint_shard{i:03d}_{epoch}.npz", part, background)
        if background:
            native.flush()  # the shards on disk before the file that references them
        meta = {**meta, "__shards__": layout, "__epoch__": epoch}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    _write(final, payload, background)
    if prev_epoch is not None and prev_epoch != meta.get("__epoch__"):
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
