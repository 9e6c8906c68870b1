"""Leveled structured key-value logging (CometBFT: libs/log/).

Mirrors the reference's go-kit style: loggers carry bound fields
(``with_fields``), emit ``tmfmt``-like lines
(``I[2026-07-30|00:00:00.000] message        module=consensus height=5``),
and a per-module level filter (libs/log/filter.go) gates output so one
chatty module can be silenced without losing error visibility.

The default sink is stderr; a node wires a file sink via config. Writes
are mutex-serialized — log lines from 20 threads must not interleave.
"""

from __future__ import annotations

import sys
import time

from . import sync as libsync

DEBUG, INFO, ERROR, NONE = 0, 1, 2, 3
_LEVEL_CHAR = {DEBUG: "D", INFO: "I", ERROR: "E"}
_LEVEL_BY_NAME = {
    "debug": DEBUG,
    "info": INFO,
    "error": ERROR,
    "none": NONE,
}


def parse_level(name: str) -> int:
    try:
        return _LEVEL_BY_NAME[name.strip().lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}")


class Logger:
    """A sink + bound fields + level filter. Cheap to derive, safe to
    share across threads."""

    def __init__(
        self,
        sink=None,
        level: int = INFO,
        fields: dict | None = None,
        module_levels: dict[str, int] | None = None,
        _lock=None,
    ):
        self._sink = sink if sink is not None else sys.stderr
        self._level = level
        self._fields = dict(fields or {})
        # SHARED (like _lock) so set_module_level on any derived logger
        # affects the whole tree — the 'silence one module' use case
        self._module_levels = (
            module_levels if module_levels is not None else {}
        )
        self._lock = _lock if _lock is not None else libsync.Mutex("libs.log")

    # -- derivation --------------------------------------------------------

    def with_fields(self, **fields) -> "Logger":
        merged = dict(self._fields)
        merged.update(fields)
        return Logger(
            self._sink, self._level, merged, self._module_levels, self._lock
        )

    def with_module(self, module: str) -> "Logger":
        return self.with_fields(module=module)

    def set_module_level(self, module: str, level: int) -> None:
        """Per-module override (libs/log/filter.go AllowLevelWith)."""
        self._module_levels[module] = level

    # -- emission ----------------------------------------------------------

    def _enabled(self, level: int) -> bool:
        module = self._fields.get("module")
        threshold = self._module_levels.get(module, self._level)
        return level >= threshold and level != NONE

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        if not self._enabled(level):
            return
        now = time.time()
        stamp = time.strftime("%Y-%m-%d|%H:%M:%S", time.localtime(now))
        ms = int(now * 1000) % 1000
        fields = dict(self._fields)
        fields.update(kv)
        parts = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        line = (
            f"{_LEVEL_CHAR[level]}[{stamp}.{ms:03d}] "
            f"{msg:<44}{(' ' + parts) if parts else ''}\n"
        )
        with self._lock:
            try:
                self._sink.write(line)
                self._sink.flush()
            except Exception:
                pass  # a dead sink must never take the node down

    def debug(self, msg: str, **kv) -> None:
        self._emit(DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit(INFO, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit(ERROR, msg, kv)


def _fmt(v) -> str:
    if isinstance(v, bytes):
        return v.hex()[:16].upper()
    if isinstance(v, float):
        return f"{v:.3f}"
    s = str(v)
    return f'"{s}"' if " " in s else s


class NopLogger(Logger):
    def __init__(self):
        super().__init__(level=NONE)

    def _emit(self, level, msg, kv) -> None:
        pass


_default = Logger()


def default_logger() -> Logger:
    return _default
