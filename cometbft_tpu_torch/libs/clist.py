"""Concurrent doubly-linked list (reference: libs/clist/clist.go:407).

The mempool/evidence gossip structure: elements are never moved, only
appended and removed; readers hold an element and call ``next_wait`` to
block until a successor exists (how per-peer broadcast routines tail the
pool without polling).
"""

from __future__ import annotations

from . import sync as libsync
from typing import Any

MAX_LENGTH = 1 << 30


class CElement:
    __slots__ = ("value", "_prev", "_next", "_removed", "_cv", "_list")

    def __init__(self, value: Any, list_: "CList"):
        self.value = value
        self._prev: CElement | None = None
        self._next: CElement | None = None
        self._removed = False
        self._list = list_
        self._cv = libsync.Condition()

    def next(self) -> "CElement | None":
        with self._cv:
            return self._next

    def prev(self) -> "CElement | None":
        with self._cv:
            return self._prev

    @property
    def removed(self) -> bool:
        with self._cv:
            return self._removed

    def next_wait(self, timeout: float | None = None) -> "CElement | None":
        """Block until this element has a successor or is removed."""
        with self._cv:
            if not self._cv.wait_for(
                lambda: self._next is not None or self._removed, timeout
            ):
                return None
            return self._next

    def _set_next(self, nxt: "CElement | None") -> None:
        with self._cv:
            self._next = nxt
            self._cv.notify_all()

    def _set_prev(self, prv: "CElement | None") -> None:
        with self._cv:
            self._prev = prv

    def _mark_removed(self) -> None:
        with self._cv:
            self._removed = True
            self._cv.notify_all()


class CList:
    def __init__(self, max_length: int = MAX_LENGTH):
        self._mtx = libsync.RLock("libs.clist._mtx")
        self._head: CElement | None = None
        self._tail: CElement | None = None
        self._len = 0
        self._max_length = max_length
        self._wait_cv = libsync.Condition(self._mtx)

    def __len__(self) -> int:
        with self._mtx:
            return self._len

    def front(self) -> CElement | None:
        with self._mtx:
            return self._head

    def back(self) -> CElement | None:
        with self._mtx:
            return self._tail

    def front_wait(self, timeout: float | None = None) -> CElement | None:
        """Block until the list is non-empty."""
        with self._mtx:
            if not self._wait_cv.wait_for(
                lambda: self._head is not None, timeout
            ):
                return None
            return self._head

    def push_back(self, value: Any) -> CElement:
        with self._mtx:
            if self._len >= self._max_length:
                raise OverflowError("clist at max length")
            el = CElement(value, self)
            if self._tail is None:
                self._head = self._tail = el
            else:
                el._set_prev(self._tail)
                self._tail._set_next(el)
                self._tail = el
            self._len += 1
            self._wait_cv.notify_all()
            return el

    def remove(self, el: CElement) -> Any:
        with self._mtx:
            if el.removed:
                return el.value
            prv, nxt = el.prev(), el.next()
            if self._head is el:
                self._head = nxt
            if self._tail is el:
                self._tail = prv
            if prv is not None:
                prv._set_next(nxt)
            if nxt is not None:
                nxt._set_prev(prv)
            self._len -= 1
            el._mark_removed()
            return el.value

    def __iter__(self):
        el = self.front()
        while el is not None:
            if not el.removed:
                yield el
            el = el.next()
