"""Loguru-style logging shim over stdlib logging.

The reference uses loguru (`server.py:6`, `infer_v2.py:17`) with info / success /
warning / error levels.  loguru is not available here, so this module provides a
compatible surface (`logger.info/.success/.warning/.error/.debug/.trace`) backed
by stdlib logging, keeping field names and level semantics.
"""

from __future__ import annotations

import logging as _logging
import sys

SUCCESS = 25
TRACE = 5
_logging.addLevelName(SUCCESS, "SUCCESS")
_logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": _logging.DEBUG,
    "info": _logging.INFO,
    "success": SUCCESS,
    "warning": _logging.WARNING,
    "error": _logging.ERROR,
    "critical": _logging.CRITICAL,
}


class _Logger:
    def __init__(self, name: str = "voice_tts_tpu_torch"):
        self._log = _logging.getLogger(name)
        if not self._log.handlers:
            handler = _logging.StreamHandler(sys.stderr)
            handler.setFormatter(_logging.Formatter(
                "%(asctime)s | %(levelname)-8s | %(name)s - %(message)s"))
            self._log.addHandler(handler)
            self._log.setLevel(_logging.INFO)
            self._log.propagate = False

    def set_level(self, level: str) -> None:
        self._log.setLevel(_LEVELS[level.lower()])

    def trace(self, msg, *a): self._log.log(TRACE, msg, *a)
    def debug(self, msg, *a): self._log.debug(msg, *a)
    def info(self, msg, *a): self._log.info(msg, *a)
    def success(self, msg, *a): self._log.log(SUCCESS, msg, *a)
    def warning(self, msg, *a): self._log.warning(msg, *a)
    def error(self, msg, *a): self._log.error(msg, *a)
    def critical(self, msg, *a): self._log.critical(msg, *a)
    def exception(self, msg, *a): self._log.exception(msg, *a)


logger = _Logger()
