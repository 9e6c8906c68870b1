"""Rotating file groups (CometBFT: libs/autofile/group.go:540).

``Group`` appends to ``<path>`` (the "head") and rotates it to
``<path>.000``, ``<path>.001``, … when it exceeds ``head_size_limit``;
oldest files are dropped once the group exceeds ``group_size_limit``.
libs/trace's file sink and the consensus WAL sit on top of this.
``GroupReader`` reads the whole group in order (rotated files first, head
last), which WAL replay and ``search_for_end_height`` use.
"""

from __future__ import annotations

import os
import re
import threading

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # 10MB (group.go:27)
DEFAULT_GROUP_SIZE_LIMIT = 1024 * 1024 * 1024  # 1GB (group.go:28)

_INDEX_RE = re.compile(r"\.(\d{3,})$")


class Group:
    def __init__(
        self,
        head_path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        group_size_limit: int = DEFAULT_GROUP_SIZE_LIMIT,
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.group_size_limit = group_size_limit
        self._mtx = threading.Lock()
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")

    # -- writing -----------------------------------------------------------

    def write(self, data: bytes) -> None:
        with self._mtx:
            self._head.write(data)

    def flush(self) -> None:
        with self._mtx:
            self._head.flush()

    def flush_and_sync(self) -> None:
        with self._mtx:  # the WAL's durability point: write, then fsync
            self._head.flush()
            os.fsync(self._head.fileno())

    def check_head_size_limit(self) -> None:
        """Rotate the head if over its limit and drop the oldest files past
        the group's (the trace sink calls it after each drain)."""
        with self._mtx:
            self._head.flush()
            if self._head.tell() >= self.head_size_limit:
                self._rotate()
            self._check_total_size()

    def _rotate(self) -> None:
        self._head.close()
        idx = self.max_index() + 1
        os.replace(self.head_path, f"{self.head_path}.{idx:03d}")
        self._head = open(self.head_path, "ab")

    def _check_total_size(self) -> None:
        while True:
            paths = self._rotated_paths()
            total = sum(os.path.getsize(p) for p in paths) + self._head.tell()
            if total <= self.group_size_limit or not paths:
                return
            os.remove(paths[0])  # drop the oldest

    # -- indexes -----------------------------------------------------------

    def _rotated_paths(self) -> list[str]:
        d = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        out = []
        for name in os.listdir(d):
            if not name.startswith(base + "."):
                continue
            m = _INDEX_RE.search(name)
            if m:
                out.append((int(m.group(1)), os.path.join(d, name)))
        return [p for _, p in sorted(out)]

    def max_index(self) -> int:
        paths = self._rotated_paths()
        if not paths:
            return -1
        return int(_INDEX_RE.search(paths[-1]).group(1))

    def min_index(self) -> int:
        paths = self._rotated_paths()
        if not paths:
            return 0
        return int(_INDEX_RE.search(paths[0]).group(1))

    def all_paths(self) -> list[str]:
        """Rotated files in order, then the head."""
        return self._rotated_paths() + [self.head_path]

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            self._head.close()


class GroupReader:
    """Sequential reader over a whole group (rotated files, then head)."""

    def __init__(self, group: Group):
        group.flush()
        self._paths = group.all_paths()
        self._i = 0
        self._f = None
        self._advance()

    def _advance(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        while self._i < len(self._paths):
            p = self._paths[self._i]
            self._i += 1
            if os.path.exists(p):
                self._f = open(p, "rb")
                return

    def read(self, n: int) -> bytes:
        out = b""
        while n > 0 and self._f is not None:
            chunk = self._f.read(n)
            if chunk:
                out += chunk
                n -= len(chunk)
            else:
                self._advance()
        return out

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
