"""Leveled logger with user callback.

Parity: handler/logger.dart (192 LoC) + model/log_config.dart — levels
debug/info/warning/error, process-wide config, `on_log` user callback
(reference onLogHandler, README.md:1415-1435).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "none": 100}


class LogConfig:
    level: str = "warning"
    on_log: Callable[[str, str, str], None] | None = None  # (level, tag, msg)
    stream = sys.stderr

    @classmethod
    def set_config(cls, level: str | None = None, on_log=None, stream=None):
        if level is not None:
            if level not in LEVELS:
                raise ValueError(f"unknown log level {level!r}")
            cls.level = level
        if on_log is not None:
            cls.on_log = on_log
        if stream is not None:
            cls.stream = stream


class Logger:
    _lock = threading.Lock()

    def __init__(self, tag: str):
        self.tag = tag

    def _log(self, level: str, msg: str):
        if LEVELS[level] < LEVELS[LogConfig.level]:
            return
        if LogConfig.on_log is not None:
            LogConfig.on_log(level, self.tag, msg)
            return
        ts = time.strftime("%H:%M:%S")
        with Logger._lock:
            try:
                print(
                    f"[{ts}] {level.upper():7s} {self.tag}: {msg}",
                    file=LogConfig.stream,
                )
            except ValueError:
                # the stream was closed under us (interpreter teardown,
                # pytest capture exit): logging must never crash a
                # background thread
                pass

    def debug(self, msg: str):
        self._log("debug", msg)

    def info(self, msg: str):
        self._log("info", msg)

    def warning(self, msg: str):
        self._log("warning", msg)

    def error(self, msg: str):
        self._log("error", msg)
