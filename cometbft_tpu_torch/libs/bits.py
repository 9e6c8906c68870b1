"""Thread-safe bit array (reference: libs/bits/bit_array.go).

Port of cometbft_tpu/libs/bits.py.

Used for vote bookkeeping (which validators have voted) and block-part
tracking; gossip messages exchange these to decide what to send a peer.
"""

from __future__ import annotations

import random
import threading


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)
        self._mtx = threading.Lock()

    @classmethod
    def from_indices(cls, bits: int, indices) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def to_bytes(self) -> bytes:
        with self._mtx:
            return bytes(self._elems)

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        ba = cls(bits)
        if len(data) != len(ba._elems):
            raise ValueError(
                f"bit array of {bits} bits needs {len(ba._elems)} bytes, "
                f"got {len(data)}"
            )
        ba._elems[:] = data
        # Zero-tail invariant: every predicate (is_full/__eq__/or_) assumes
        # bits past `bits` are 0.
        rem = bits % 8
        if rem and ba._elems:
            ba._elems[-1] &= (1 << rem) - 1
        return ba

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._mtx:
            return bool(self._elems[i // 8] >> (i % 8) & 1)

    def set_index(self, i: int, value: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._mtx:
            if value:
                self._elems[i // 8] |= 1 << (i % 8)
            else:
                self._elems[i // 8] &= ~(1 << (i % 8))
            return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.bits)
        with self._mtx:
            ba._elems = bytearray(self._elems)
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        """Union, sized to the larger operand (bit_array.go Or)."""
        out = BitArray(max(self.bits, other.bits))
        with self._mtx:
            mine = bytes(self._elems)
        with other._mtx:
            theirs = bytes(other._elems)
        for i, b in enumerate(mine):
            out._elems[i] |= b
        for i, b in enumerate(theirs):
            out._elems[i] |= b
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.bits, other.bits))
        with self._mtx:
            mine = bytes(self._elems)
        with other._mtx:
            theirs = bytes(other._elems)
        for i in range(len(out._elems)):
            out._elems[i] = mine[i] & theirs[i]
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        with self._mtx:
            for i in range(len(self._elems)):
                out._elems[i] = ~self._elems[i] & 0xFF
        # mask tail bits beyond size
        extra = len(out._elems) * 8 - self.bits
        if extra and out._elems:
            out._elems[-1] &= 0xFF >> extra
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (bit_array.go Sub)."""
        out = self.copy()
        n = min(self.bits, other.bits)
        for i in range(n):
            if other.get_index(i):
                out.set_index(i, False)
        return out

    def is_empty(self) -> bool:
        with self._mtx:
            return not any(self._elems)

    def is_full(self) -> bool:
        if self.bits == 0:
            return True
        with self._mtx:
            whole, rem = divmod(self.bits, 8)
            if any(b != 0xFF for b in self._elems[:whole]):
                return False
            if rem:
                return self._elems[whole] == (1 << rem) - 1
            return True

    def pick_random(self, rng: random.Random | None = None) -> tuple[int, bool]:
        """A uniformly random set bit, or (0, False) if none."""
        trues = self.get_true_indices()
        if not trues:
            return 0, False
        return (rng or random).choice(trues), True

    def get_true_indices(self) -> list[int]:
        with self._mtx:
            return [
                i
                for i in range(self.bits)
                if self._elems[i // 8] >> (i % 8) & 1
            ]

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and bytes(self._elems) == bytes(other._elems)
        )

    def __str__(self) -> str:
        return "".join(
            "x" if self.get_index(i) else "_" for i in range(self.bits)
        )
