"""Named loggers with per-run file sinks + console.

Counterpart of ``tnl_lbm_tpu/utils/logging_utils.py`` (reference
lbm_common/logging.h:13-77): loggers "main", "profile" and "ibm" with a console
sink and per-run file sinks ``<results_dir>/log_<name>``.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

_PREFIX = "tnl_lbm_tpu_torch"
_CONFIGURED: set = set()
#: the per-run file sinks by (logger name, file), each with the number of
#: holders (``init_logging`` calls not yet released)
_FILES: dict = {}


def init_logging(results_dir=None, names=("main", "profile", "ibm"), level=logging.INFO):
    for name in names:
        logger = logging.getLogger(f"{_PREFIX}.{name}")
        logger.setLevel(level)
        logger.propagate = False
        if name not in _CONFIGURED:
            console = logging.StreamHandler(sys.stderr)
            console.setFormatter(logging.Formatter("[%(asctime)s] [%(name)s] %(message)s", "%H:%M:%S"))
            if name != "main":
                console.setLevel(logging.WARNING)
            logger.addHandler(console)
            _CONFIGURED.add(name)
        if results_dir is not None:
            path = Path(results_dir) / f"log_{name}"
            key = (name, str(path.resolve()))
            if key in _FILES:
                _FILES[key][1] += 1
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
            logger.addHandler(fh)
            _FILES[key] = [fh, 1]


def release_logging(results_dir, names=("main", "profile", "ibm")):
    """Drop one hold on a run directory's file sinks (one ``init_logging``
    call); the last one closes them.  A process that runs many runs (a
    sweep) would otherwise keep every run's files open and write each
    message to all of them."""
    for name in names:
        key = (name, str((Path(results_dir) / f"log_{name}").resolve()))
        entry = _FILES.get(key)
        if entry is None:
            continue
        entry[1] -= 1
        if entry[1] <= 0:
            logging.getLogger(f"{_PREFIX}.{name}").removeHandler(entry[0])
            entry[0].close()
            del _FILES[key]


def get_logger(name="main") -> logging.Logger:
    return logging.getLogger(f"{_PREFIX}.{name}")
