"""Colored stderr logging, reference-compatible.

Mirrors ``ColorLogger`` (reference: src/lib.rs:45-109): ERROR red, WARN
yellow, everything else blue; all output to stderr; ``-q`` silences
everything and ``-v`` enables trace-level output (src/lib.rs:51-57).
"""

from __future__ import annotations

import logging
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_RED = "\x1b[31m"
_YELLOW = "\x1b[33m"
_BLUE = "\x1b[34m"
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):
    def __init__(self, color: bool = True):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        level = record.levelname
        msg = record.getMessage()
        line = f"[{level}] {msg}"
        if not self.color:
            return line
        if record.levelno >= logging.ERROR:
            return f"{_RED}{line}{_RESET}"
        if record.levelno >= logging.WARNING:
            return f"{_YELLOW}{line}{_RESET}"
        return f"{_BLUE}{line}{_RESET}"


def get_logger() -> logging.Logger:
    return logging.getLogger("dsd2dxd")


def init_logging(verbose: bool = False, quiet: bool = False) -> logging.Logger:
    """Level mapping per reference src/lib.rs:51-57: quiet -> off,
    verbose -> trace, default -> info."""
    logger = get_logger()
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(ColorFormatter(color=sys.stderr.isatty()))
    logger.addHandler(handler)
    if quiet:
        logger.setLevel(logging.CRITICAL + 1)
    elif verbose:
        logger.setLevel(TRACE)
    else:
        logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger
