"""Consensus write-ahead log (reference: consensus/wal.go:59-435).

Every message the consensus loop consumes (peer msgs, own msgs, timeouts)
is written BEFORE processing; own messages are fsynced (state.go:805) so a
crash cannot double-sign. Records are CRC-framed over a rotating autofile
``Group``; ``EndHeightMessage`` marks height boundaries for
``search_for_end_height`` (replay start discovery, wal.go:232).

Record frame: ``crc32(payload) u32 | len u32 | payload`` where payload is
tagged JSON of one of the message dataclasses.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from array import array

from ..libs import sync as libsync
import zlib

from ..libs import autofile
from ..libs import fail as libfail
from ..libs import health as libhealth
from ..libs import trace as libtrace
from ..libs.jsoncodec import Codec
from ..types import serialization as ser

_FRAME = struct.Struct("<II")
MAX_MSG_BYTES = 1 << 20  # wal.go maxMsgSizeBytes

# -- slow-disk degradation (gray-failure defense) -----------------------
#
# A disk that is slow-but-alive is invisible to liveness checks: fsyncs
# still return, the node still votes — just late enough that every
# propose timeout it owns expires and rounds spin. The WAL tracks an
# EWMA of its own fsync latency; when the EWMA crosses the degradation
# threshold the node enters a `disk_degraded` state that (a) widens its
# propose timeouts (consensus/state.py) so the chain slows instead of
# spinning rounds, and (b) trips the `slow_disk` health watchdog
# (libs/health) for a black-box bundle. Hysteresis: the state clears
# only once the EWMA falls below half the threshold, so a latency
# hovering at the edge cannot flap timeouts every other height.
_ENV_DISK_EWMA = "COMETBFT_TPU_HEALTH_DISK_EWMA"
_ENV_DISK_MS = "COMETBFT_TPU_HEALTH_DISK_MS"
DEFAULT_DISK_EWMA_WINDOW = 8  # EWMA alpha = 2 / (window + 1)
DEFAULT_DISK_DEGRADED_MS = 50.0


def _disk_ewma_alpha() -> float:
    window = libhealth._env_float(
        _ENV_DISK_EWMA, DEFAULT_DISK_EWMA_WINDOW
    )
    return 2.0 / (max(1.0, window) + 1.0)


def _disk_degraded_ns() -> float:
    ms = libhealth._env_float(_ENV_DISK_MS, DEFAULT_DISK_DEGRADED_MS)
    return max(0.1, ms) * 1e6


@dataclasses.dataclass(slots=True)
class EndHeightMessage:
    """Marks that ``height`` is fully committed (wal.go:38)."""

    height: int


@dataclasses.dataclass(slots=True)
class MsgInfo:
    """A consensus message + where it came from ("" = internal)."""

    msg: object
    peer_id: str = ""


@dataclasses.dataclass(slots=True)
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int  # RoundStep value


# WAL codec shares the types codec so Vote/Proposal/Block payloads nest.
wal_codec: Codec = ser.codec
wal_codec.register(EndHeightMessage, MsgInfo, TimeoutInfo)


class WALError(Exception):
    pass


class WAL:
    """BaseWAL (wal.go:77): framed records over an autofile Group."""

    def __init__(self, path: str, head_size_limit: int | None = None):
        kwargs = {}
        if head_size_limit is not None:
            kwargs["head_size_limit"] = head_size_limit
        self.group = autofile.Group(path, **kwargs)
        self._mtx = libsync.Mutex("consensus.wal._mtx")
        self._msgs_since_sync = 0
        # slow-disk state: [fsync EWMA ns, degraded flag] — preallocated
        # scalar slots, written under the fsync path's own timing branch
        self._disk = array("d", [0.0, 0.0])
        self._disk_alpha = _disk_ewma_alpha()
        self._disk_threshold_ns = _disk_degraded_ns()
        # Seed a brand-new WAL with #ENDHEIGHT 0 so replay can always find
        # a marker (wal.go OnStart); absence later = corruption.
        if self.group.max_index() < 0 and os.path.getsize(path) == 0:
            self.write_end_height(0)

    # -- write -------------------------------------------------------------

    def write(self, msg) -> None:
        payload = wal_codec.dumps(msg)
        if len(payload) > MAX_MSG_BYTES:
            raise WALError(f"msg of {len(payload)}B exceeds WAL limit")
        frame = _FRAME.pack(zlib.crc32(payload), len(payload)) + payload
        with self._mtx:
            self.group.write(frame)
            self.group.flush()

    def write_sync(self, msg, overlapped: bool = False) -> None:
        """fsync before returning — required before signing own msgs.
        ``overlapped=True`` marks an fsync that runs OFF the FSM critical
        section (the pipelined commit-writer): the flight-recorder row is
        flagged so the budget plane credits it outside the serial span."""
        self.write(msg)
        timed = libtrace.enabled() or libhealth.enabled()
        t0 = time.perf_counter() if timed else 0.0
        libfail.delay_point("wal-fsync")
        with self._mtx:  # cometlint: disable=CLNT009 -- the WAL mutex serializes frame write+fsync (wal.go WriteSync)
            self.group.flush_and_sync()
        if timed:
            dur_ns = int((time.perf_counter() - t0) * 1e9)
            self._note_fsync(dur_ns)
            libhealth.record(
                libhealth.EV_FSYNC, a=dur_ns, b=1 if overlapped else 0
            )
            if libtrace.enabled():
                libtrace.event("wal.fsync", dur_ns=dur_ns)

    def flush_and_sync(self) -> None:
        timed = libtrace.enabled() or libhealth.enabled()
        t0 = time.perf_counter() if timed else 0.0
        libfail.delay_point("wal-fsync")
        with self._mtx:  # cometlint: disable=CLNT009 -- flush_and_sync is the caller-requested fsync point
            self.group.flush_and_sync()
        if timed:
            dur_ns = int((time.perf_counter() - t0) * 1e9)
            self._note_fsync(dur_ns)
            libhealth.record(libhealth.EV_FSYNC, a=dur_ns)
            if libtrace.enabled():
                libtrace.event("wal.fsync", dur_ns=dur_ns)

    # -- slow-disk state (see the module-level notes) -------------------

    def _note_fsync(self, dur_ns: int) -> None:
        """Fold one measured fsync into the EWMA + hysteresis state.
        Lock-free scalar stores; the writers already serialize on the
        WAL mutex for the fsync itself."""
        d = self._disk
        ewma = d[0]
        ewma = dur_ns if ewma == 0.0 else (
            self._disk_alpha * dur_ns + (1.0 - self._disk_alpha) * ewma
        )
        d[0] = ewma
        if d[1] == 0.0:
            if ewma > self._disk_threshold_ns:
                d[1] = 1.0
        elif ewma < 0.5 * self._disk_threshold_ns:
            d[1] = 0.0

    def fsync_ewma_s(self) -> float:
        """Smoothed fsync latency (seconds; 0.0 before any sample)."""
        return self._disk[0] / 1e9

    def disk_degraded(self) -> bool:
        """Whether this WAL's disk is in the degraded (slow) state."""
        return self._disk[1] != 0.0

    def write_end_height(self, height: int, overlapped: bool = False) -> None:
        self.write_sync(EndHeightMessage(height), overlapped=overlapped)
        self.group.check_head_size_limit()

    # -- read --------------------------------------------------------------

    def iter_messages(self):
        """Yield every decodable message in order; stops at the first torn
        or corrupt record (crash tail)."""
        reader = autofile.GroupReader(self.group)
        try:
            while True:
                hdr = reader.read(_FRAME.size)
                if len(hdr) < _FRAME.size:
                    return
                crc, length = _FRAME.unpack(hdr)
                if length > MAX_MSG_BYTES:
                    return
                payload = reader.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                try:
                    yield wal_codec.loads(payload)
                except Exception:
                    return
        finally:
            reader.close()

    def search_for_end_height(self, height: int) -> list | None:
        """Messages AFTER ``EndHeightMessage(height)``, or None if that
        marker never appears (wal.go SearchForEndHeight:232)."""
        found = False
        out: list = []
        for msg in self.iter_messages():
            if isinstance(msg, EndHeightMessage):
                if msg.height == height:
                    found = True
                    out = []
                continue
            if found:
                out.append(msg)
        return out if found else None

    def close(self) -> None:
        self.group.close()


class NopWAL:
    """WAL that drops everything (wal.go nilWAL — used by tools/tests)."""

    def fsync_ewma_s(self) -> float:
        return 0.0

    def disk_degraded(self) -> bool:
        return False

    def write(self, msg) -> None:
        pass

    def write_sync(self, msg, overlapped: bool = False) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def write_end_height(self, height: int, overlapped: bool = False) -> None:
        pass

    def iter_messages(self):
        return iter(())

    def search_for_end_height(self, height: int):
        return None

    def close(self) -> None:
        pass
