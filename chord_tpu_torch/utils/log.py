"""Logging (port of chord_tpu/utils/log.py: one stderr sink under the
package's logger name, reference source/utils/log.h)."""

from __future__ import annotations

import logging
import sys

_ROOT = "chord_tpu_torch"
_FORMAT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    root.setLevel(logging.INFO)
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root.addHandler(h)
    root.propagate = False
    _configured = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
