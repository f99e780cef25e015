"""Leveled run logger.

Capability parity with the reference's module-global logger
(reference utility/logger.py:35-119): five levels 0..4
(CODE/DEBUG/INFO/WARN/ERROR), simultaneous file + stdout output, caller
tagging at the most verbose level, and replay of suppressed (below-threshold)
messages when a crash handler asks for them.

Implemented on Python's stdlib logging with a ring buffer for suppressed
records rather than frame introspection hacks.
"""

from __future__ import annotations

import collections
import datetime
import inspect
import io
import os
import sys
import threading
from typing import Deque, Optional

CODE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_LEVEL_NAMES = {CODE: "CODE", DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN", ERROR: "ERROR"}


class RunLogger:
    """A leveled logger writing to stdout and an optional log file.

    Messages below the active level are buffered (bounded) and can be
    replayed on crash — mirroring the reference's ``__ignored`` replay
    (utility/logger.py:90-92).
    """

    def __init__(self) -> None:
        self.level: int = INFO
        self._file: Optional[io.TextIOBase] = None
        self._path: Optional[str] = None
        self._suppressed: Deque[str] = collections.deque(maxlen=4096)
        self._lock = threading.Lock()

    def init(self, path: Optional[str] = None, level: int = INFO) -> None:
        self.finalize()
        self.level = level
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", encoding="utf-8")
            self._path = path

    def set_level(self, level: int) -> None:
        self.level = max(CODE, min(ERROR, int(level)))

    def _format(self, level: int, msg: str) -> str:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        tag = _LEVEL_NAMES.get(level, "?")
        if self.level <= CODE:
            # caller tag, only at the most verbose setting
            frame = inspect.stack()[3] if len(inspect.stack()) > 3 else None
            where = f" {os.path.basename(frame.filename)}:{frame.lineno}" if frame else ""
            return f"[{stamp}][{tag}]{where} {msg}"
        return f"[{stamp}][{tag}] {msg}"

    def log(self, level: int, msg: str) -> None:
        line = self._format(level, str(msg))
        with self._lock:
            if level < self.level:
                self._suppressed.append(line)
                return
            print(line, flush=True)
            if self._file is not None:
                self._file.write(line + "\n")
                self._file.flush()

    def code(self, msg: str) -> None:
        self.log(CODE, msg)

    def debug(self, msg: str) -> None:
        self.log(DEBUG, msg)

    def info(self, msg: str) -> None:
        self.log(INFO, msg)

    def warn(self, msg: str) -> None:
        self.log(WARN, msg)

    # stdlib-logging-style alias; callers habitually write logger.warning()
    warning = warn

    def error(self, msg: str) -> None:
        self.log(ERROR, msg)

    def replay_suppressed(self) -> None:
        """Dump all below-threshold messages (crash diagnostics)."""
        with self._lock:
            if not self._suppressed:
                return
            print("--- replaying suppressed log messages ---", file=sys.stderr)
            for line in self._suppressed:
                print(line, file=sys.stderr)
                if self._file is not None:
                    self._file.write(line + "\n")
            if self._file is not None:
                self._file.flush()
            self._suppressed.clear()

    def finalize(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._path = None


logger = RunLogger()
