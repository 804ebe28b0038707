"""Coloured console logger (reference lib/utils/logger.py).

In a data-parallel run the ranks other than 0 log warnings and errors
only (JAX's utils/logger.py:29 logs on process 0); rank 0 logs from INFO.
The recorder, which only rank 0 creates, adds the per-experiment log
file (set_log_file).
"""

from __future__ import annotations

import logging
import sys

from color_neus_torch.parallel.mesh import is_rank0

_COLORS = {"DEBUG": "\033[36m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m", "CRITICAL": "\033[35m"}
_RESET = "\033[0m"


class _RankFilter(logging.Filter):
    """Below WARNING, rank 0's records only."""

    def filter(self, record):
        return record.levelno >= logging.WARNING or is_rank0()


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        return f"{color}{msg}{_RESET}" if sys.stderr.isatty() else msg


def _make_logger() -> logging.Logger:
    log = logging.getLogger("color_neus_torch")
    log.setLevel(logging.INFO)
    log.propagate = False
    if not log.filters:
        log.addFilter(_RankFilter())
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
