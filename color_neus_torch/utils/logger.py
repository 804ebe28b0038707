"""Coloured console logger (reference lib/utils/logger.py).

One process for now: the port has no multi-GPU path yet, so there is no
rank check. The recorder adds the per-experiment log file (set_log_file).
"""

from __future__ import annotations

import logging
import sys

_COLORS = {"DEBUG": "\033[36m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m", "CRITICAL": "\033[35m"}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        return f"{color}{msg}{_RESET}" if sys.stderr.isatty() else msg


def _make_logger() -> logging.Logger:
    log = logging.getLogger("color_neus_torch")
    log.setLevel(logging.INFO)
    log.propagate = False
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter("%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S"))
        log.addHandler(h)
    return log


logger = _make_logger()


def set_log_file(path: str) -> None:
    """Also write the log to `path` (one file at a time)."""
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(fh)
