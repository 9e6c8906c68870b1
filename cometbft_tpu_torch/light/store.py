"""Trusted light blocks in memory (reference: light/store.py MemStore).

The reference's db-backed ``Store`` (light/store/db/db.go) waits for the
port of libs/db and types/serialization; ``MemStore`` has the same
contract and keeps the LightBlock objects themselves.
"""

from __future__ import annotations

import threading

from ..types.light_block import LightBlock
from .errors import LightBlockNotFoundError


class MemStore:
    """Trusted-block store: heights -> LightBlocks, thread-safe."""

    def __init__(self):
        self._mtx = threading.Lock()
        self._blocks: dict[int, LightBlock] = {}

    def save_light_block(self, lb: LightBlock) -> None:
        if lb.height <= 0:
            raise ValueError("height must be positive")
        with self._mtx:
            self._blocks[lb.height] = lb

    def delete_light_block(self, height: int) -> None:
        if height <= 0:
            raise ValueError("height must be positive")
        with self._mtx:
            self._blocks.pop(height, None)

    def prune(self, size: int) -> None:
        """Delete the oldest blocks until at most ``size`` remain."""
        with self._mtx:
            excess = len(self._blocks) - size
            for h in sorted(self._blocks):
                if excess <= 0:
                    break
                del self._blocks[h]
                excess -= 1

    def light_block(self, height: int) -> LightBlock:
        if height <= 0:
            raise ValueError("height must be positive")
        with self._mtx:
            lb = self._blocks.get(height)
        if lb is None:
            raise LightBlockNotFoundError(height)
        return lb

    def last_light_block_height(self) -> int:
        """-1 when empty (store.go:27-30)."""
        with self._mtx:
            return max(self._blocks) if self._blocks else -1

    def first_light_block_height(self) -> int:
        with self._mtx:
            return min(self._blocks) if self._blocks else -1

    def light_block_before(self, height: int) -> LightBlock:
        """Latest stored block strictly below ``height``."""
        with self._mtx:
            below = [h for h in self._blocks if h < height]
            if below:
                return self._blocks[max(below)]
        raise LightBlockNotFoundError(height)

    def size(self) -> int:
        with self._mtx:
            return len(self._blocks)
