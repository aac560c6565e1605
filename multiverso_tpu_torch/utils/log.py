"""Leveled logging + CHECK macros.

Parity with the reference logger (``include/multiverso/util/log.h:9-142``):
Debug/Info/Error/Fatal levels, optional file sink, Fatal kills the process
(toggleable), and ``check``/``check_notnull`` assertion helpers that route to
Fatal.
"""

from __future__ import annotations

import collections
import enum
import os
import sys
import threading
import time
from typing import Any, List, Optional


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3
    FATAL = 4


class FatalError(RuntimeError):
    """Raised by Log.fatal when kill-on-fatal is disabled."""


class Logger:
    #: Recent-line ring depth: the flight recorder's log tail
    #: (telemetry/flight.py) reads the crash-adjacent window from here.
    RING_DEPTH = 256

    def __init__(self, level: LogLevel = LogLevel.INFO):
        self._level = level
        self._file = None
        self._kill_fatal = False  # raise by default; os._exit if enabled
        self._lock = threading.Lock()
        self._ring: "collections.deque[str]" = collections.deque(
            maxlen=self.RING_DEPTH)

    # -- configuration -----------------------------------------------------
    def set_level(self, level: LogLevel) -> None:
        self._level = LogLevel(level)

    def get_level(self) -> LogLevel:
        return self._level

    def set_log_file(self, path: Optional[str]) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if path:
                self._file = open(path, "a", buffering=1)

    def set_kill_fatal(self, kill: bool) -> None:
        self._kill_fatal = bool(kill)

    # -- emit --------------------------------------------------------------
    def _emit(self, level: LogLevel, msg: str, *args: Any) -> None:
        if level < self._level:
            return
        if args:
            msg = msg % args
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        line = f"[{level.name}] [{stamp}] [{os.getpid()}] {msg}"
        with self._lock:
            self._ring.append(line)
            stream = sys.stderr if level >= LogLevel.ERROR else sys.stdout
            # The ONE sanctioned print in the framework: this module IS
            # the emitter everything else routes through.
            print(line, file=stream)  # graftlint: disable=bare-print
            if self._file is not None:
                self._file.write(line + "\n")

    def recent(self, n: int = 100) -> List[str]:
        """The last ``n`` emitted lines (bounded ring, always on) — the
        postmortem's crash-adjacent log window."""
        with self._lock:
            return list(self._ring)[-max(int(n), 1):]

    def raw(self, msg: str, *args: Any) -> None:
        """Un-leveled, un-stamped line to stdout (+ file sink): CLI result
        output (topic lists, reports) whose format is the interface. The
        sanctioned alternative to a bare ``print`` in framework code (the
        no-bare-print lint allows only this module)."""
        if args:
            msg = msg % args
        with self._lock:
            sys.stdout.write(msg + "\n")
            if self._file is not None:
                self._file.write(msg + "\n")

    def debug(self, msg: str, *args: Any) -> None:
        self._emit(LogLevel.DEBUG, msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self._emit(LogLevel.INFO, msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        """Notable-but-survivable: lost heartbeats, retried refreshes.
        (Several long-standing call sites used this name against the
        4-level reference enum and died with AttributeError the first
        time their failure path actually fired — a dropped stalled peer
        took the whole ps_service sweeper thread with it.)"""
        self._emit(LogLevel.WARNING, msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self._emit(LogLevel.ERROR, msg, *args)

    def fatal(self, msg: str, *args: Any) -> None:
        self._emit(LogLevel.FATAL, msg, *args)
        if self._kill_fatal:
            os._exit(1)
        raise FatalError(msg % args if args else msg)


log = Logger()


def check(condition: Any, msg: str = "CHECK failed") -> None:
    """``CHECK`` macro analog (ref log.h:9-13)."""
    if not condition:
        log.fatal("%s", msg)


def check_notnull(value: Any, name: str = "value") -> Any:
    """``CHECK_NOTNULL`` analog (ref log.h:15-18)."""
    if value is None:
        log.fatal("'%s' must not be None", name)
    return value
