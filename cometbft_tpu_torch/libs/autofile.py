"""Rotating file groups (CometBFT: libs/autofile/group.go:540).

``Group`` appends to ``<path>`` (the "head") and rotates it to
``<path>.000``, ``<path>.001``, … when it exceeds ``head_size_limit``;
oldest files are dropped once the group exceeds ``group_size_limit``.
libs/trace's file sink sits on top of this (the JAX package's consensus
WAL does too, with a reader over the group that comes here with the WAL).
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

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            self._head.close()
