"""Error types and exit-code mapping.

Mirrors the reference's error plumbing: ``MyError``/``TermResult`` map any
engine error to a logged red ``[ERROR]`` line and process exit code 1
(reference: src/lib.rs:8-43).
"""

from __future__ import annotations


class Dsd2DxdError(Exception):
    """Base error; CLI maps this to exit code 1 with a red [ERROR] line."""


class FormatError(Dsd2DxdError):
    """Malformed or unsupported container/bitstream."""


class ConfigError(Dsd2DxdError):
    """Invalid user configuration (bad flag combination, rate matrix, ...)."""


class CancelledError(Dsd2DxdError):
    """Conversion cancelled cooperatively (reference: src/main.rs:38)."""
