"""Leveled, colored logger (a copy of the JAX package's
utils/logging_util.py, mirroring the reference's header-only Logger,
src/util/LogUtils.h:52-255): ms timestamps, ANSI colors, a global level
(default INFO), and brace-style formatting via str.format.
"""
from __future__ import annotations

import sys
import time
from enum import IntEnum


class Level(IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3
    OFF = 4


_COLORS = {
    Level.DEBUG: "\033[36m",
    Level.INFO: "\033[32m",
    Level.WARN: "\033[33m",
    Level.ERROR: "\033[31m",
}
_RESET = "\033[0m"

level: Level = Level.INFO
_use_color = sys.stderr.isatty()
_t0 = time.monotonic()


def set_level(new_level: Level) -> None:
    global level
    level = new_level


def _log(msg_level: Level, fmt: str, *args) -> None:
    if msg_level < level:
        return
    ts_ms = (time.monotonic() - _t0) * 1000.0
    text = fmt.format(*args) if args else fmt
    tag = msg_level.name
    if _use_color:
        color = _COLORS.get(msg_level, "")
        print(f"{color}[{ts_ms:10.1f}ms][{tag:5s}]{_RESET} {text}", file=sys.stderr)
    else:
        print(f"[{ts_ms:10.1f}ms][{tag:5s}] {text}", file=sys.stderr)


def debug(fmt: str, *args) -> None:
    _log(Level.DEBUG, fmt, *args)


def info(fmt: str, *args) -> None:
    _log(Level.INFO, fmt, *args)


def warn(fmt: str, *args) -> None:
    _log(Level.WARN, fmt, *args)


def error(fmt: str, *args) -> None:
    _log(Level.ERROR, fmt, *args)
