"""Logging (port of chord_tpu/utils/log.py; reference source/utils/log.h):
one stderr sink under the package's logger name, push/pop callback taps
for UI consoles (the editor's console) and an optional file sink."""

from __future__ import annotations

import logging
import sys
from typing import Callable, List

_ROOT = "chord_tpu_torch"
_FORMAT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"
_configured = False
_taps: List[Callable[[str], None]] = []


class _TapHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        msg = self.format(record)
        for tap in list(_taps):
            tap(msg)


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    root.setLevel(logging.INFO)
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root.addHandler(h)
    th = _TapHandler()
    th.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root.addHandler(th)
    root.propagate = False
    _configured = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def push_tap(cb: Callable[[str], None]) -> None:
    """Register a log tap (reference utils/log.h:42-49 pushCallback): `cb`
    receives every formatted record of the package's loggers."""
    _configure()
    _taps.append(cb)


def pop_tap(cb: Callable[[str], None]) -> None:
    if cb in _taps:
        _taps.remove(cb)


def enable_file_log(path: str) -> None:
    """Add a file sink (the reference's "r.log.file" sink)."""
    _configure()
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter(_FORMAT))
    logging.getLogger(_ROOT).addHandler(h)
