"""Leveled logging with an in-memory ring buffer.

Re-provides the reference's klog usage (structured leveled logging with
`-v` verbosity on every binary, reference pkg/theia/commands/root.go and
cmd/theia-manager/theia-manager.go:117 log-file monitoring): messages
above the configured verbosity are dropped, the rest go to stderr AND a
bounded in-memory ring so the support bundle can ship recent logs the
way the reference's ManagerDumper copies log files out of pods
(pkg/support/dump.go:55-66).
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Deque, Optional
from ..analysis.lockdep import named_lock

_RING_CAPACITY = 5000

_lock = named_lock("utils.logging")
_verbosity = 0
_ring: Deque[str] = collections.deque(maxlen=_RING_CAPACITY)


def set_verbosity(v: int) -> None:
    """Global `-v` level: 0 = info/warn/error only, higher enables
    matching `logger.v(n)` messages."""
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def dump_logs() -> str:
    """All retained log lines, oldest first (support-bundle payload)."""
    with _lock:
        return "\n".join(_ring)


def clear_logs() -> None:
    with _lock:
        _ring.clear()


def _emit(level: str, name: str, msg: str, stream: bool = True) -> None:
    ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
    line = f"{ts} {level} {name}: {msg}"
    with _lock:
        _ring.append(line)
    if stream:
        print(line, file=sys.stderr)


class Logger:
    """Named logger; `v(2).info(...)` mirrors klog.V(2).Infof."""

    def __init__(self, name: str, level: Optional[int] = None) -> None:
        self.name = name
        self._level = level  # None = unconditional

    def v(self, level: int) -> "Logger":
        return Logger(self.name, level)

    def _enabled(self) -> bool:
        return self._level is None or self._level <= _verbosity

    def info(self, msg: str, *args: object) -> None:
        if self._enabled():
            _emit("I", self.name, msg % args if args else msg,
                  stream=self._level is None or _verbosity > 0)

    def warning(self, msg: str, *args: object) -> None:
        _emit("W", self.name, msg % args if args else msg)

    def error(self, msg: str, *args: object) -> None:
        _emit("E", self.name, msg % args if args else msg)


def get_logger(name: str) -> Logger:
    return Logger(name)
