"""Key-value store abstraction (reference: cometbft-db dependency).

The reference stores blocks/state/indexes on a pluggable KV interface
(goleveldb default — config/config.go:256). Here the same interface is a
small ABC with two backends:

* ``MemDB`` — sorted in-memory store (tests, ephemeral nodes).
* ``FileDB`` — persistent append-only log with in-memory index and
  compaction, durable across restarts. Plays goleveldb's role without a
  native dependency; the interface leaves room for a C++ backend later.

Iteration is ordered by raw bytes, half-open ``[start, end)``, matching the
reference semantics that the indexers and stores rely on.
"""

from __future__ import annotations

import os
import struct
from . import sync as libsync
from bisect import bisect_left, insort
from typing import Iterator


class DB:
    """The cometbft-db interface subset the framework uses."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    def iterator(
        self, start: bytes | None = None, end: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def reverse_iterator(
        self, start: bytes | None = None, end: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def new_batch(self) -> "Batch":
        return Batch(self)

    def close(self) -> None:
        pass


class Batch:
    """Write batch: buffered mutations applied atomically on ``write()``."""

    def __init__(self, db: DB):
        self._db = db
        self._ops: list[tuple[bool, bytes, bytes]] = []

    def set(self, key: bytes, value: bytes) -> None:
        self._ops.append((True, bytes(key), bytes(value)))

    def delete(self, key: bytes) -> None:
        self._ops.append((False, bytes(key), b""))

    def write(self) -> None:
        self._db.apply_batch(self._ops)
        self._ops = []

    def write_sync(self) -> None:
        self.write()


class MemDB(DB):
    def __init__(self) -> None:
        self._mtx = libsync.RLock("libs.db._mtx")
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted view for iteration

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._data.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._mtx:
            if key not in self._data:
                insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key in self._data:
                del self._data[key]
                i = bisect_left(self._keys, key)
                del self._keys[i]

    def apply_batch(self, ops: list[tuple[bool, bytes, bytes]]) -> None:
        with self._mtx:  # cometlint: disable=CLNT009 -- MemDB batch is memory-only; FileDB's fsync sites carry their own justification
            for is_set, k, v in ops:
                if is_set:
                    self.set(k, v)
                else:
                    self.delete(k)

    def _range_keys(self, start: bytes | None, end: bytes | None) -> list[bytes]:
        lo = 0 if start is None else bisect_left(self._keys, bytes(start))
        hi = len(self._keys) if end is None else bisect_left(self._keys, bytes(end))
        return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        with self._mtx:
            keys = self._range_keys(start, end)
            snap = [(k, self._data[k]) for k in keys]
        yield from snap

    def reverse_iterator(self, start=None, end=None):
        with self._mtx:
            keys = self._range_keys(start, end)
            snap = [(k, self._data[k]) for k in reversed(keys)]
        yield from snap


def prefix_end(prefix: bytes) -> bytes | None:
    """Smallest key greater than every key with the given prefix, or None
    if no such key exists (prefix is all 0xff). For prefix iteration:
    ``db.iterator(p, prefix_end(p))`` covers exactly the keys under ``p``.
    """
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


# FileDB file framing: 5-byte magic, then records of
# u8 op | u32 klen | u32 vlen | key | value.
# The magic distinguishes this format from the native engine's
# CRC-framed "NKV1\n" files: opening a foreign-format file raises
# instead of parsing zero records and truncating the database to zero
# (a flipped db_backend in config must not silently erase data).
# Deliberately NO legacy (pre-magic) acceptance path: the formats are
# pre-release with no deployed data dirs, and sniffing legacy records
# is exactly the ambiguity that allowed cross-format erasure (both
# framings begin with a plausible op byte).
_HDR = struct.Struct("<BII")
_OP_SET, _OP_DEL, _OP_BATCH = 1, 2, 3
_MAGIC = b"FKV1\n"


class FileDB(MemDB):
    """Durable log-structured store: MemDB index + append-only on-disk log.

    Every mutation appends a framed record; ``compact()`` (run automatically
    when the log grows past ``compact_factor`` × live size) rewrites the log
    to just the live records. A torn final record (crash mid-append) is
    truncated on open — the same recover-to-last-good-record posture the
    reference's WAL takes (consensus/wal.go). Batches are one BATCH record
    (sub-records nested in its value), so a batch is atomic under crash:
    either the whole record replays or the torn tail is dropped.
    """

    def __init__(self, path: str, compact_factor: int = 4):
        super().__init__()
        self._path = path
        self._compact_factor = compact_factor
        self._live_bytes = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            self._f.write(_MAGIC)
            self._f.flush()

    def _replay(self) -> None:
        if not os.path.exists(self._path):
            return
        if os.path.getsize(self._path) == 0:
            return
        good = len(_MAGIC)
        with open(self._path, "rb") as f:
            head = f.read(len(_MAGIC))
            if len(head) < len(_MAGIC) and head == _MAGIC[: len(head)]:
                # crash between file creation and the magic becoming
                # durable: a strict prefix of the magic is a torn tail of
                # an EMPTY database, not a foreign format — reset to
                # empty (the constructor rewrites the magic)
                with open(self._path, "r+b") as t:
                    t.truncate(0)
                return
            if head != _MAGIC:
                raise ValueError(
                    f"{self._path}: not a FileDB file (bad magic "
                    f"{head!r}; native-engine files start with b'NKV1\\n' "
                    f"— was db_backend changed?)"
                )
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                op, klen, vlen = _HDR.unpack(hdr)
                body = f.read(klen + vlen)
                if len(body) < klen + vlen or op not in (
                    _OP_SET,
                    _OP_DEL,
                    _OP_BATCH,
                ):
                    break
                key, value = body[:klen], body[klen:]
                if op == _OP_SET:
                    super().set(key, value)
                elif op == _OP_DEL:
                    super().delete(key)
                else:
                    try:
                        sub = self._decode_batch(value)
                    except ValueError:
                        break
                    for is_set, k, v in sub:
                        if is_set:
                            super().set(k, v)
                        else:
                            super().delete(k)
                good = f.tell()
        size = os.path.getsize(self._path)
        if size > good:
            with open(self._path, "r+b") as f:
                f.truncate(good)
        self._recount()

    def _recount(self) -> None:
        self._live_bytes = sum(
            _HDR.size + len(k) + len(v) for k, v in self._data.items()
        )

    def _append(self, op: int, key: bytes, value: bytes, sync: bool) -> None:
        self._f.write(_HDR.pack(op, len(key), len(value)) + key + value)
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())

    def _account(self, key: bytes, new_value: bytes | None) -> None:
        """Update the live-size estimate across an overwrite or delete.
        Must run BEFORE the in-memory update (needs the old value)."""
        old = self._data.get(key)
        if old is not None:
            self._live_bytes -= _HDR.size + len(key) + len(old)
        if new_value is not None:
            self._live_bytes += _HDR.size + len(key) + len(new_value)

    def _set_locked(self, key: bytes, value: bytes, sync: bool) -> None:
        self._account(key, value)
        super().set(key, value)
        self._append(_OP_SET, key, value, sync=sync)
        self._maybe_compact()

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:  # cometlint: disable=CLNT009 -- FileDB's mutex is the atomicity boundary for the append-log record
            self._set_locked(bytes(key), bytes(value), sync=False)

    def set_sync(self, key: bytes, value: bytes) -> None:
        with self._mtx:  # cometlint: disable=CLNT009 -- set_sync exists to fsync under the DB mutex: the durability contract
            self._set_locked(bytes(key), bytes(value), sync=True)

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:  # cometlint: disable=CLNT009 -- delete record must pair with the in-memory delete atomically
            self._account(key, None)
            super().delete(key)
            self._append(_OP_DEL, key, b"", sync=False)

    @staticmethod
    def _decode_batch(blob: bytes) -> list[tuple[bool, bytes, bytes]]:
        ops, pos = [], 0
        while pos < len(blob):
            if pos + _HDR.size > len(blob):
                raise ValueError("truncated batch sub-record")
            op, klen, vlen = _HDR.unpack_from(blob, pos)
            pos += _HDR.size
            if pos + klen + vlen > len(blob) or op not in (_OP_SET, _OP_DEL):
                raise ValueError("corrupt batch sub-record")
            ops.append(
                (op == _OP_SET, blob[pos : pos + klen], blob[pos + klen : pos + klen + vlen])
            )
            pos += klen + vlen
        return ops

    def apply_batch(self, ops: list[tuple[bool, bytes, bytes]]) -> None:
        blob = b"".join(
            _HDR.pack(_OP_SET if is_set else _OP_DEL, len(k), len(v)) + k + v
            for is_set, k, v in ops
        )
        with self._mtx:  # cometlint: disable=CLNT009 -- a batch is one atomic fsynced log record
            for is_set, k, v in ops:
                self._account(k, v if is_set else None)
                if is_set:
                    MemDB.set(self, k, v)
                else:
                    MemDB.delete(self, k)
            self._append(_OP_BATCH, b"", blob, sync=True)
            self._maybe_compact()

    def _maybe_compact(self) -> None:
        log_size = self._f.tell()
        if log_size > max(1 << 16, self._compact_factor * self._live_bytes):
            self.compact()

    def compact(self) -> None:
        with self._mtx:  # cometlint: disable=CLNT009 -- compaction rewrites the log; the mutex holds off writers
            tmp = self._path + ".compact"
            with open(tmp, "wb") as out:
                out.write(_MAGIC)
                for k in self._keys:
                    v = self._data[k]
                    out.write(_HDR.pack(_OP_SET, len(k), len(v)) + k + v)
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            os.replace(tmp, self._path)
            self._f = open(self._path, "ab")
            self._recount()

    def close(self) -> None:
        with self._mtx:
            self._f.close()
