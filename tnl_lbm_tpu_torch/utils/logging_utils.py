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
            path.parent.mkdir(parents=True, exist_ok=True)
            if not any(
                isinstance(h, logging.FileHandler) and h.baseFilename == str(path.resolve())
                for h in logger.handlers
            ):
                fh = logging.FileHandler(path)
                fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
                logger.addHandler(fh)


def get_logger(name="main") -> logging.Logger:
    return logging.getLogger(f"{_PREFIX}.{name}")
