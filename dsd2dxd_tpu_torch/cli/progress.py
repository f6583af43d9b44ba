"""Multi-file terminal progress bars.

Replaces the reference's indicatif MultiProgress + log bridge
(reference src/main.rs:145-146, 396-426): one bar per in-flight file,
template ``[Converting] name |####----| 42%``, drawn to stderr only when
it is a TTY, and coordinated with log output so lines don't clobber bars
(the indicatif-log-bridge behavior). Bars are suppressed when converting
stdin or writing to stdout (reference README.md:14-15).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

_BAR_WIDTH = 20


class ProgressBar:
    def __init__(self, manager: "MultiProgress", prefix: str, name: str):
        self._mgr = manager
        self.prefix = prefix
        self.name = name
        self.percent = 0.0
        self.done = False

    def update(self, percent: float) -> None:
        self.percent = min(max(percent, 0.0), 100.0)
        self._mgr._redraw()

    def finish(self) -> None:
        self.percent = 100.0
        self.done = True
        self._mgr._finish(self)

    def render(self) -> str:
        filled = int(_BAR_WIDTH * self.percent / 100.0)
        bar = "#" * filled + "-" * (_BAR_WIDTH - filled)
        return f"{self.prefix} {self.name} |{bar}| {self.percent:3.0f}%"


class MultiProgress:
    """Thread-safe multi-bar renderer. ``log_guard()`` lets the logger
    print a line without corrupting the bar block."""

    def __init__(self, enabled: Optional[bool] = None,
                 min_interval: float = 0.05):
        self.enabled = sys.stderr.isatty() if enabled is None else enabled
        self._bars: list[ProgressBar] = []
        self._lock = threading.RLock()
        self._drawn_lines = 0
        self._last_draw = 0.0
        self._min_interval = min_interval

    def add(self, name: str, prefix: str = "[Converting]") -> ProgressBar:
        bar = ProgressBar(self, prefix, name)
        with self._lock:
            self._bars.append(bar)
            self._redraw(force=True)
        return bar

    def _finish(self, bar: ProgressBar) -> None:
        with self._lock:
            self._clear()
            if bar in self._bars:
                if self.enabled:
                    sys.stderr.write(bar.render() + "\n")
                self._bars.remove(bar)
            self._draw()

    def _clear(self) -> None:
        if not self.enabled or self._drawn_lines == 0:
            return
        sys.stderr.write(f"\x1b[{self._drawn_lines}F\x1b[J")
        self._drawn_lines = 0

    def _draw(self) -> None:
        if not self.enabled:
            return
        for bar in self._bars:
            sys.stderr.write(bar.render() + "\n")
        self._drawn_lines = len(self._bars)
        sys.stderr.flush()

    def _redraw(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        if not force and now - self._last_draw < self._min_interval:
            return
        with self._lock:
            self._last_draw = now
            self._clear()
            self._draw()

    def log_guard(self):
        """Context manager: clears bars, lets the caller write, redraws."""
        mgr = self

        class _Guard:
            def __enter__(self):
                mgr._lock.acquire()
                mgr._clear()

            def __exit__(self, *exc):
                mgr._draw()
                mgr._lock.release()
                return False

        return _Guard()

    def close(self) -> None:
        with self._lock:
            self._clear()


class ProgressAwareHandler:
    """Wrap a logging handler's emit so log lines and bars interleave
    cleanly (the indicatif-log-bridge role, reference src/main.rs:146)."""

    def __init__(self, manager: MultiProgress):
        self._mgr = manager

    def wrap(self, handler):
        inner_emit = handler.emit

        def emit(record):
            with self._mgr.log_guard():
                inner_emit(record)

        handler.emit = emit
        return handler
