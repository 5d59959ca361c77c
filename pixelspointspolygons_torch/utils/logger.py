"""Rank-aware colored logging (the port's own copy of `make_logger` in
pixelspointspolygons_tpu/utils/logger.py; reference misc/logger.py:11-116):
non-zero processes are demoted to WARNING so multi-host runs stay readable.
Implemented without the colorlog dependency (plain ANSI).
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        if sys.stderr.isatty():
            return f"{color}{base}{_RESET}"
        return base


def make_logger(name: str, level: int = logging.INFO, local_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level if local_rank == 0 else logging.WARNING)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            _ColorFormatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
        )
        logger.addHandler(h)
        logger.propagate = False
    return logger
