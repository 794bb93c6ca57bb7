"""Leveled, timestamped, colored logger with optional file sink.

Counterpart: `tpu_pathtracer/utils/logger.py` (copied).

Capability parity with the reference's OptixLogger singleton
(`include/utils/optix_logger.h:42-200` of the CUDA reference): seven levels
(TRACE..NONE), millisecond timestamps, ANSI colors on TTYs, a module tag,
an optional file sink, and throughput helpers (MRays/s). Built on Python's
stdlib logging so it is thread-safe and plays well with pytest capture.
"""

from __future__ import annotations

import logging
import sys
import time

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_COLORS = {
    TRACE: "\033[90m",
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"

_root = logging.getLogger("tpu_pathtracer_torch")
_configured = False


class _Formatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        t = time.localtime(record.created)
        ms = int(record.msecs)
        stamp = time.strftime("%H:%M:%S", t) + f".{ms:03d}"
        tag = record.name.split(".")[-1]
        line = f"[{stamp}] [{record.levelname:<7}] [{tag}] {record.getMessage()}"
        if self.color:
            c = _COLORS.get(record.levelno, "")
            return f"{c}{line}{_RESET}" if c else line
        return line


def configure(level: int = logging.INFO, log_file: str | None = None) -> None:
    """(Re)configure the framework-wide logger."""
    global _configured
    for h in list(_root.handlers):
        _root.removeHandler(h)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(_Formatter(color=sys.stderr.isatty()))
    _root.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_Formatter(color=False))
        _root.addHandler(fh)
    _root.setLevel(level)
    _configured = True


def get_logger(tag: str) -> logging.Logger:
    if not _configured:
        configure()
    return _root.getChild(tag)


def log_ray_stats(tag: str, num_rays: int, seconds: float) -> float:
    """MRays/s helper (optix_logger.h:131-138). Returns the rate."""
    rate = (num_rays / 1e6) / max(seconds, 1e-12)
    get_logger(tag).info(
        "%d rays in %.2f ms -> %.2f MRays/s", num_rays, seconds * 1e3, rate
    )
    return rate
