"""Logging tier: Logger / Appender / Formatter (a copy of the JAX
package's core/logger.py; the port imports nothing of that package).

Reference: include/mitsuba/core/logger.h:116 (Logger),
appender.h:33,65 (Appender/StreamAppender), formatter.h:42
(DefaultFormatter), logger.cpp. One process-global Logger serves the host
program (kernels never log: what is worth reporting comes back as tensors
and is logged on the host), with the same level gate / appender /
formatter split so tools can attach file appenders or custom formats.

Levels mirror ELogLevel (logger.h): ETrace(1) EDebug(100) EInfo(200)
EWarn(300) EError(400).
"""
from __future__ import annotations

import sys
import time
from typing import Callable, List, TextIO

ETrace = 1
EDebug = 100
EInfo = 200
EWarn = 300
EError = 400

_LEVEL_NAMES = {ETrace: "TRACE", EDebug: "DEBUG", EInfo: "INFO",
                EWarn: "WARN", EError: "ERROR"}


def default_formatter(level: int, msg: str) -> str:
    """DefaultFormatter (formatter.h:42): time, level, message."""
    t = time.strftime("%Y-%m-%d %H:%M:%S")
    return f"{t} {_LEVEL_NAMES.get(level, level):>5} [mitsuba_tpu_torch] {msg}"


class StreamAppender:
    """appender.h:65 — writes formatted records to a text stream."""

    def __init__(self, stream: TextIO = None):
        self.stream = stream if stream is not None else sys.stderr

    def append(self, level: int, text: str) -> None:
        print(text, file=self.stream)
        try:
            self.stream.flush()
        except Exception:
            pass


class FileAppender(StreamAppender):
    """appender.h UnbufferedAppender analog — appends to a log file."""

    def __init__(self, path: str):
        self._fh = open(path, "a")
        super().__init__(self._fh)

    def close(self) -> None:
        self._fh.close()


class Logger:
    """logger.h:116 — level-gated dispatch to appenders.

    EError raises (the reference throws after logging)."""

    def __init__(self, level: int = EInfo):
        self.level = level
        self.error_level = EError
        self.appenders: List[StreamAppender] = [StreamAppender()]
        self.formatter: Callable[[int, str], str] = default_formatter
        self.warning_count = 0

    def set_log_level(self, level: int) -> None:
        self.level = level

    def add_appender(self, app: StreamAppender) -> None:
        self.appenders.append(app)

    def clear_appenders(self) -> None:
        self.appenders = []

    def log(self, level: int, msg: str) -> None:
        if level >= EWarn:
            self.warning_count += level < self.error_level
        if level >= self.level:
            text = self.formatter(level, msg)
            for app in self.appenders:
                app.append(level, text)
        if level >= self.error_level:
            raise RuntimeError(msg)


_logger = Logger()


def get_logger() -> Logger:
    return _logger


def set_log_level(level: int) -> None:
    _logger.set_log_level(level)


def Log(level: int, msg: str, *args) -> None:
    """mitsuba's Log(ELevel, fmt, ...) macro analog."""
    _logger.log(level, msg % args if args else msg)
