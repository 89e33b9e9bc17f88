"""Run-directory file utilities: locks and flags.

Counterpart of ``tnl_lbm_tpu/utils/fileutils.py`` (reference
lbm_common/fileutils.h:5-166): ``mkdir_p``, atomic publishing by rename,
flock-based run locking that refuses double-running, and the
``flag.<name>`` state files.
"""

from __future__ import annotations

import fcntl
import os
from pathlib import Path


def mkdir_p(path) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)


def create_file(path) -> None:
    mkdir_p(Path(path).parent)
    Path(path).touch()


def rename_exchange(src, dst) -> None:
    """Atomically publish ``src`` at ``dst``: an existing ``dst`` is
    exchanged, never destroyed before the new file is in place (reference
    fileutils.h:100-138); otherwise a plain atomic rename."""
    src, dst = os.fspath(src), os.fspath(dst)
    if os.path.exists(dst):
        try:
            os.rename(src, dst + ".old")
            os.rename(dst, src)
            os.rename(dst + ".old", dst)
            return
        except OSError:
            pass
    os.replace(src, dst)


class FileLock:
    """Non-blocking exclusive flock (reference fileutils.h:142-166)."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._fd = None

    def try_lock(self) -> bool:
        create_file(self.path)
        self._fd = os.open(self.path, os.O_RDWR)
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return True
        except OSError:
            os.close(self._fd)
            self._fd = None
            return False

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


class Flags:
    """Flag files controlling the run state machine
    (reference state.hpp:12-38: flag.{loadstate,finished,terminated})."""

    def __init__(self, directory):
        self.dir = Path(directory)

    def path(self, name) -> Path:
        return self.dir / f"flag.{name}"

    def exists(self, name) -> bool:
        return self.path(name).exists()

    def create(self, name) -> None:
        create_file(self.path(name))

    def delete(self, name) -> None:
        try:
            self.path(name).unlink()
        except FileNotFoundError:
            pass
