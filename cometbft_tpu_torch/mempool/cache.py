"""Seen-tx dedup cache (reference: mempool/cache.go:120)."""

from __future__ import annotations

from ..libs import sync as libsync
from collections import OrderedDict


class LRUTxCache:
    def __init__(self, size: int):
        self._size = size
        self._mtx = libsync.Mutex("mempool.cache._mtx")
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def push(self, tx_key: bytes) -> bool:
        """True if newly added; False if already present (moves to front)."""
        with self._mtx:
            if tx_key in self._map:
                self._map.move_to_end(tx_key)
                return False
            if len(self._map) >= self._size:
                self._map.popitem(last=False)
            self._map[tx_key] = None
            return True

    def remove(self, tx_key: bytes) -> None:
        with self._mtx:
            self._map.pop(tx_key, None)

    def has(self, tx_key: bytes) -> bool:
        with self._mtx:
            return tx_key in self._map

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()


class NopTxCache:
    def push(self, tx_key: bytes) -> bool:
        return True

    def remove(self, tx_key: bytes) -> None:
        pass

    def has(self, tx_key: bytes) -> bool:
        return False

    def reset(self) -> None:
        pass
