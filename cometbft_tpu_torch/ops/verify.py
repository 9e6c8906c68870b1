"""Host <-> device glue for batched ed25519 verification.

Split of labor:

* Host (numpy + hashlib): length checks, the SHA-512 challenge
  k = SHA512(R || A || M) mod L, the canonicality check S < L, and the
  compact wire rows (128 B per lane: A | R | S | -k mod L).
* Device (torch + the kernels of ops/cuda_verify.py): byte unpacking
  into limbs, sign bits and nibbles, point decompression, the windowed
  double-scalar ladder, and the bit-packed verdicts (bucket/8 bytes back).

Steady state goes through the :class:`PubkeyTableCache`: a validator's
decompressed key and 16-entry table live in a device arena, a commit ships
96 B per lane plus a uint16 slot, and K2 reads the table in place. A
batch that names no cache goes through the process-wide one of its device
(:func:`pubkey_cache`) unless ``COMETBFT_TPU_PUBKEY_CACHE=0``;
:func:`prestage_pubkeys` warms it ahead of a commit.

Entry points take ``device=`` and default to ``"cuda"``; without a GPU
they raise instead of running on the CPU. ``device="cpu"`` runs the plain
PyTorch versions of the kernels (the tests' path).

They also take ``flavor=``: ``"4"`` runs the joint 4-bit ladder (K1/K2),
``"8"`` takes [S]B from 8-bit fixed-base windows (K3/K4), and ``None``
reads ``COMETBFT_TPU_KERNEL`` at call time with the reference's values:
``pallas8`` and ``xla8`` mean 8-bit; ``auto`` (the default), ``pallas`` and
``xla`` mean 4-bit. Any other value raises. The wire is the same for both
flavors: in the 8-bit one S stays raw little-endian bytes on the device.

With two or more CUDA devices :func:`verify_batch` shards a batch over
all of them instead (:func:`_verify_batch_sharded`, parallel/mesh.py):
the lanes are unpacked on the host (:func:`pack_inputs`, 680 B a lane)
and each device runs K1 on its share. Every call reports its phases to
libs/metrics (``crypto_verify_phase_seconds``, ``verify.*`` trace
events) and its transfers to libs/devstats.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from ..crypto import ed25519_ref
from ..libs import accel as libaccel
from ..libs import devstats as libdevstats
from ..libs import metrics as libmetrics
from ..libs import sync as libsync
from . import cuda_verify, curve, field

L = curve.L
_MIN_BUCKET = 8
# Largest lane count per launch: bigger batches split into _CHUNK-lane
# launches.
_CHUNK = 16384


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises for CUDA without a usable GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


# COMETBFT_TPU_KERNEL values -> flavor. "auto" is 4-bit: the reference's
# order when it has no chip data; the port never reads the TPU's
# BENCH_CHIP_TABLE.json.
_KERNEL_FLAVORS = {"auto": "4", "pallas": "4", "xla": "4",
                   "pallas8": "8", "xla8": "8"}
FLAVORS = ("4", "8")


def kernel_flavor(flavor=None) -> str:
    """``"4"`` or ``"8"``: ``flavor`` itself, or with None the flavor that
    ``COMETBFT_TPU_KERNEL`` names now. Anything else raises ValueError."""
    if flavor is None:
        mode = os.environ.get("COMETBFT_TPU_KERNEL", "auto")
        if mode not in _KERNEL_FLAVORS:
            raise ValueError(
                f"COMETBFT_TPU_KERNEL={mode!r}: expected one of "
                f"{sorted(_KERNEL_FLAVORS)}"
            )
        return _KERNEL_FLAVORS[mode]
    if flavor not in FLAVORS:
        raise ValueError(f"flavor {flavor!r}: expected '4', '8' or None")
    return flavor


def bucket_size(n: int) -> int:
    """Smallest wire bucket holding n (8 <= bucket <= _CHUNK): powers of
    two plus the 3*2^k midpoints that are multiples of 512 (1536, 3072,
    6144, 12288). The bit-packed verdicts travel at this size; the wire
    rows and the kernels take only the n real lanes."""
    assert n <= _CHUNK, n
    b = _MIN_BUCKET
    while b < n:
        mid = b + b // 2
        if mid >= n and mid % 512 == 0:
            return mid
        b *= 2
    return b


_Z96 = bytes(96)
_Z128 = bytes(128)


def pack_bytes(pubkeys, msgs, sigs) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing to the compact device wire format.

    Returns (buf (128, n) uint8, host_ok (n,) bool). Rows 0-31 pubkey,
    32-63 R, 64-95 S, 96-127 (-k mod L), all little-endian bytes.
    Malformed inputs (wrong lengths, non-canonical S >= L) get
    host_ok=False and zeroed rows.

    The SHA-512 challenges and -k mod L come from the native engine
    (crypto/host_batch.pack_challenges); Python keeps only the length
    checks and bulk joins. An engine that does not build raises: there is
    no fallback to :func:`pack_bytes_plain`, which gives the same bytes.
    """
    from ..crypto import host_batch

    n = len(pubkeys)
    host_ok = np.ones(n, bool)
    recs = []
    msg_parts = []
    lens = np.zeros(n, np.uint64)
    for i in range(n):
        p_i, s_i = pubkeys[i], sigs[i]
        if len(p_i) != 32 or len(s_i) != 64:
            host_ok[i] = False
            recs.append(_Z96)
            msg_parts.append(b"")
            continue
        recs.append(bytes(p_i) + bytes(s_i))
        m = bytes(msgs[i])
        msg_parts.append(m)
        lens[i] = len(m)
    recs_blob = b"".join(recs)
    offs = np.zeros(n + 1, np.uint64)
    np.cumsum(lens, out=offs[1:])
    kneg_blob, s_ok = host_batch.pack_challenges(
        recs_blob, b"".join(msg_parts), offs, n)
    rec_arr = np.frombuffer(recs_blob, np.uint8).reshape(n, 96)
    kneg_arr = np.frombuffer(kneg_blob, np.uint8).reshape(n, 32)
    buf = np.ascontiguousarray(np.concatenate([rec_arr, kneg_arr], axis=1).T)
    host_ok &= s_ok
    bad = ~host_ok
    if bad.any():  # malformed lanes ship zeroed rows
        buf[:, bad] = 0
    return buf, host_ok


def pack_bytes_plain(pubkeys, msgs, sigs) -> tuple[np.ndarray, np.ndarray]:
    """:func:`pack_bytes` as one Python loop (hashlib SHA-512 and bigint
    arithmetic): the plain version that tests and chip_smoke.py hold the
    native packer against, byte for byte."""
    n = len(pubkeys)
    host_ok = np.ones(n, bool)
    pk_buf = bytearray(32 * n)
    rr_buf = bytearray(32 * n)
    ss_buf = bytearray(32 * n)
    kneg_buf = bytearray(32 * n)
    challenge = ed25519_ref.challenge_scalar
    for i in range(n):
        p_i, s_i = pubkeys[i], sigs[i]
        if len(p_i) != 32 or len(s_i) != 64:
            host_ok[i] = False
            continue
        s_int = int.from_bytes(s_i[32:], "little")
        if s_int >= L:  # S must be canonical even under ZIP-215
            host_ok[i] = False
            continue
        k = challenge(s_i[:32], p_i, msgs[i])
        o = 32 * i
        pk_buf[o : o + 32] = p_i
        rr_buf[o : o + 32] = s_i[:32]
        ss_buf[o : o + 32] = s_i[32:]
        kneg_buf[o : o + 32] = ((L - k) % L).to_bytes(32, "little")

    rows = [
        np.frombuffer(bytes(b), np.uint8).reshape(n, 32).T
        for b in (pk_buf, rr_buf, ss_buf, kneg_buf)
    ]
    return np.ascontiguousarray(np.concatenate(rows, axis=0)), host_ok


def pack_part_row(a_enc, r_enc, s_int: int, k_int: int) -> bytes:
    """One 128-byte wire row A | R | S | (-k mod L), little-endian, from a
    verification quad. :func:`pack_parts` builds through it; it is the
    layout :func:`pack_bytes` gives an ed25519 lane, and the tests hold the
    two byte for byte."""
    return (
        bytes(a_enc)
        + bytes(r_enc)
        + s_int.to_bytes(32, "little")
        + ((L - k_int) % L).to_bytes(32, "little")
    )


def pack_parts(parts) -> tuple[np.ndarray, np.ndarray]:
    """Verification quads in the wire format: (buf (128, n) uint8,
    host_ok (n,) bool). ``parts[i]`` is (A_edwards32, R_edwards32, s, k),
    or None for a lane the host rejected (a zero row, host_ok False). For
    schemes whose challenge is not SHA512(R || A || M): sr25519 computes k
    from a merlin transcript on the host and rides the same cofactored
    kernels (crypto/sr25519.py)."""
    n = len(parts)
    host_ok = np.array([part is not None for part in parts], bool)
    blob = b"".join(_Z128 if part is None else pack_part_row(*part)
                    for part in parts)
    rows = np.frombuffer(blob, np.uint8).reshape(n, 128)
    return np.ascontiguousarray(rows.T), host_ok


# -- host-side limb packing: the sharded route ships K1's arguments
# unpacked on the host (the reference's pack_inputs), not wire rows --

_LIMB_WEIGHTS = 1 << np.arange(field.BITS, dtype=np.int32)  # (13,)
_NIB_WEIGHTS = np.array([1, 2, 4, 8], np.int32)


def _le_bits(arr: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 256) bits, little-endian bit order."""
    return np.unpackbits(arr, axis=1, bitorder="little")


def _msb_nibbles(arr: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian scalars -> (64, N) int32 4-bit windows,
    MSB first. The reference's sum widens to int64; K1 takes int32, so the
    sum stays int32 here (the values are equal)."""
    bits = _le_bits(arr).reshape(arr.shape[0], 64, 4)
    nibs = (bits.astype(np.int32) * _NIB_WEIGHTS).sum(axis=2, dtype=np.int32)
    return np.ascontiguousarray(nibs[:, ::-1].T)


def _y_limbs(bits: np.ndarray) -> np.ndarray:
    """(N, 256) little-endian bits -> (20, N) 13-bit limbs of bits 0..254."""
    n = bits.shape[0]
    padded = np.zeros((n, field.NLIMB * field.BITS), np.int32)
    padded[:, :255] = bits[:, :255]
    limbs = (padded.reshape(n, field.NLIMB, field.BITS) * _LIMB_WEIGHTS).sum(
        axis=2, dtype=np.int32
    )
    return np.ascontiguousarray(limbs.T)


def pack_inputs(pubkeys, msgs, sigs) -> tuple[dict, np.ndarray]:
    """(K1's argument arrays, host_ok): the (pubkey, msg, sig) triples
    packed on the host with the batch axis last, all int32: y_a, y_r (20,
    N), sign_a, sign_r (N,), s_nibs, kneg_nibs (64, N), 680 B a lane. The
    sharded route ships these (parallel/mesh.py); the single-device route
    ships :func:`pack_bytes`' 128 B rows and unpacks on the device."""
    buf, host_ok = pack_bytes(pubkeys, msgs, sigs)
    pk_bits = _le_bits(np.ascontiguousarray(buf[0:32].T))
    rr_bits = _le_bits(np.ascontiguousarray(buf[32:64].T))
    arrays = {
        "y_a": _y_limbs(pk_bits),
        "sign_a": pk_bits[:, 255].astype(np.int32),
        "y_r": _y_limbs(rr_bits),
        "sign_r": rr_bits[:, 255].astype(np.int32),
        "s_nibs": _msb_nibbles(np.ascontiguousarray(buf[64:96].T)),
        "kneg_nibs": _msb_nibbles(np.ascontiguousarray(buf[96:128].T)),
    }
    return arrays, host_ok


# -- device-side byte unpacking (shared by the uncached, cached and
# builder paths, so the three cannot diverge) --


def _dev_le_bits(rows: torch.Tensor) -> torch.Tensor:
    """(32, N) int32 bytes -> (256, N) bits, little-endian."""
    shifts = torch.arange(8, dtype=torch.int32, device=rows.device)
    bits = (rows[:, None, :] >> shifts.reshape(1, 8, 1)) & 1
    return bits.reshape(256, rows.shape[-1])


def _dev_y_limbs(bits: torch.Tensor) -> torch.Tensor:
    """(256, N) bits -> (20, N) 13-bit limbs of bits 0..254 (bit 255 is
    the sign). y >= p stays unreduced: ZIP-215 accepts it."""
    n = bits.shape[-1]
    padded = torch.cat(
        [bits[:255], torch.zeros((5, n), dtype=torch.int32,
                                 device=bits.device)]
    )
    w = (1 << torch.arange(field.BITS, dtype=torch.int32,
                           device=bits.device)).reshape(1, -1, 1)
    return torch.sum(
        padded.reshape(field.NLIMB, field.BITS, n) * w, dim=1,
        dtype=torch.int32,
    )


def _dev_msb_nibbles(rows: torch.Tensor) -> torch.Tensor:
    """(32, N) little-endian scalar bytes -> (64, N) windows, MSB first."""
    nibs = torch.stack([rows & 15, rows >> 4], dim=1).reshape(
        64, rows.shape[-1]
    )
    return nibs.flip(0)


def _s_windows(rows: torch.Tensor, flavor: str) -> dict:
    """S's (32, N) little-endian byte rows as the flavor's kernels take
    them: 64 MSB-first 4-bit windows, or for "8" the 32 bytes themselves
    (byte j is the 8-bit window of weight 2^(8j))."""
    if flavor == "8":
        return {"s_bytes": rows.contiguous()}
    return {"s_nibs": _dev_msb_nibbles(rows)}


def unpack_on_device(buf: torch.Tensor, flavor: str = "4") -> dict:
    """(128, N) uint8 wire rows -> verify_kernel (or, for flavor "8",
    verify_kernel8) arrays, on buf's device. Bytes widen to int32 before
    any shift."""
    cuda_verify.count_op("x3_unpack", buf)
    b = buf.to(torch.int32)
    pk_bits = _dev_le_bits(b[0:32])
    rr_bits = _dev_le_bits(b[32:64])
    return {
        "y_a": _dev_y_limbs(pk_bits),
        "sign_a": pk_bits[255].contiguous(),
        "y_r": _dev_y_limbs(rr_bits),
        "sign_r": rr_bits[255].contiguous(),
        **_s_windows(b[64:96], flavor),
        "kneg_nibs": _dev_msb_nibbles(b[96:128]),
    }


def _unpack_rsk_on_device(buf: torch.Tensor, flavor: str = "4") -> dict:
    """(96, N) uint8 rows R|S|kneg -> cached-kernel arrays."""
    cuda_verify.count_op("x3_unpack", buf)
    b = buf.to(torch.int32)
    rr_bits = _dev_le_bits(b[0:32])
    return {
        "y_r": _dev_y_limbs(rr_bits),
        "sign_r": rr_bits[255].contiguous(),
        **_s_windows(b[32:64], flavor),
        "kneg_nibs": _dev_msb_nibbles(b[64:96]),
    }


# -- verdict bit-packing: the verdicts are the only payload read back,
# eight lanes to a byte. Every wire size is a bucket, so N % 8 == 0. --

_OK_BIT_WEIGHTS = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32)


def _pack_ok_bits(ok: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N//8,) uint8, little-endian bit order."""
    cuda_verify.count_op("x3_bitpack", ok)
    bits = ok.to(torch.int32).reshape(-1, 8)
    w = torch.from_numpy(_OK_BIT_WEIGHTS).to(ok.device)
    return torch.sum(bits * w, dim=1, dtype=torch.int32).to(torch.uint8)


def unpack_ok_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of :func:`_pack_ok_bits`: (n,) bool validity."""
    return np.unpackbits(
        np.ascontiguousarray(packed, np.uint8), bitorder="little"
    )[:n].astype(bool)


def _readback(ok: torch.Tensor, size: int):
    """Pad n verdicts to the wire bucket, bit-pack them on the device and
    return the closure that reads them back: (n,) bool. On CUDA the packed
    bytes are copied into a pinned buffer on the launching stream behind
    an event, so any thread may read them back: the closure waits on that
    event alone."""
    n = ok.shape[0]
    full = torch.zeros(size, dtype=torch.bool, device=ok.device)
    full[:n] = ok
    packed = _pack_ok_bits(full)
    if packed.device.type != "cuda":
        def read_cpu() -> np.ndarray:
            libdevstats.record_d2h(packed.numel())
            return unpack_ok_bits(packed.numpy(), size)[:n]

        return read_cpu
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(packed.device))

    def materialize() -> np.ndarray:
        done.synchronize()
        libdevstats.record_d2h(host.numel())
        return unpack_ok_bits(host.numpy(), size)[:n]

    return materialize


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class LaneArena:
    """Persistent staging of launch wire rows for one stream's launches.

    Per (kind, row shape, dtype, bucket) it keeps :attr:`PING_PONG` slots,
    each a host buffer (pinned on CUDA) and a device buffer of the bucket's
    size that live as long as the arena: :meth:`stage` fills the next
    slot's host buffer, copies it to the device buffer asynchronously on
    the current stream and records an event, and a slot is written again
    only after its last copy's event. Window N+1 stages into the other
    slot while window N's copy may still be in flight; the device buffers
    are reused in stream order, so an arena serves one stream (the verify
    coalescer's). A staging fault raises: a launch never goes ahead from
    anything else. Every live arena is in :data:`_LANE_ARENAS`, which
    libs/devstats samples.
    """

    PING_PONG = 2

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = libsync.Mutex("ops.verify._lane_mtx")
        self._slots: dict[tuple, deque] = {}  # of [host, dev, event]
        self.stages = 0
        self.allocs = 0  # slots made, at most PING_PONG a key
        _LANE_ARENAS.add(self)

    @property
    def reuses(self) -> int:
        """Stages that reused a slot (every stage but a slot's first)."""
        return self.stages - self.allocs

    def stage(self, kind: str, rows: np.ndarray) -> torch.Tensor:
        """``rows`` (..., n) staged on the device: a contiguous (..., n)
        view of the next slot of ``kind``'s bucket."""
        rows = np.ascontiguousarray(rows)
        n = rows.shape[-1]
        size = int(np.prod(rows.shape[:-1], dtype=np.int64)) * bucket_size(n)
        key = (kind, rows.shape[:-1], rows.dtype.str, bucket_size(n))
        cuda = self.device.type == "cuda"
        with self._lock:
            self.stages += 1
            slots = self._slots.setdefault(key, deque())
            if len(slots) < self.PING_PONG:
                dtype = torch.from_numpy(rows[..., :0]).dtype
                slot = [torch.empty(size, dtype=dtype, pin_memory=cuda),
                        torch.empty(size, dtype=dtype, device=self.device),
                        None]
                self.allocs += 1
            else:
                slot = slots.popleft()  # the older of the two
            slots.append(slot)
            host, dev, copied = slot
            if copied is not None:
                copied.synchronize()  # its last copy has left the buffer
            host[: rows.size].numpy()[:] = rows.reshape(-1)
            view = dev[: rows.size].view(rows.shape)
            view.copy_(host[: rows.size].view(rows.shape), non_blocking=cuda)
            if cuda:
                slot[2] = torch.cuda.Event()
                slot[2].record(torch.cuda.current_stream(self.device))
            return view

    def buffers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._slots.values())

    def resident_bytes(self) -> int:
        """Bytes of the device buffers held."""
        with self._lock:
            return sum(slot[1].nbytes for v in self._slots.values()
                       for slot in v)


# The live lane arenas (the verify coalescers'), for libs/devstats.
_LANE_ARENAS: "weakref.WeakSet[LaneArena]" = weakref.WeakSet()


# ------------------------------------------------------------------ cache
# Device-resident expanded-pubkey cache. The reference keeps a 4096-entry
# LRU of expanded keys because validators recur every round
# (crypto/ed25519/ed25519.go:31,56); here each key's 16-entry Niels table
# lives in a device arena, so a steady-state commit skips A's
# decompression (the ~254-squaring sqrt chain) and table build.


class PubkeyTableCache:
    """LRU arena of expanded pubkey tables resident on one device.

    The arena is ``(16, 4, 20, capacity + 1)`` int32 plus ``(capacity + 1,)``
    ok bits. The last slot is never assigned: the reference keeps it as
    scratch, and an arena carries over between the two shape for shape.
    Thread-safe. An update writes a NEW arena tensor (copy, then scatter),
    so a verify launched against the arena a lookup handed out keeps
    reading the tables it was given: an eviction never rewrites a slot an
    in-flight launch reads. On CUDA each write records an event on the
    writer's stream, and :meth:`lookup` makes the caller's current stream
    wait for it, so a launch on another stream (the verify coalescer's)
    reads the tables written.
    """

    # One full _CHUNK of distinct signers stays cacheable: ~84 MB.
    CAPACITY = 16384

    def __init__(self, device="cuda", capacity: int = CAPACITY):
        if not 0 < capacity < 1 << 16:
            raise ValueError("capacity must be in [1, 65535]: uint16 slots")
        self.device = resolve_device(device)
        self.capacity = capacity
        self._lock = libsync.Mutex("ops.verify._lock")
        self._slots: OrderedDict[bytes, int] = OrderedDict()
        self._arena = torch.zeros(
            (curve.TSIZE, 4, field.NLIMB, capacity + 1), dtype=torch.int32,
            device=self.device,
        )
        self._arena_ok = torch.zeros(
            capacity + 1, dtype=torch.bool, device=self.device
        )
        self._written = None
        self._mark_written()
        self.hits = 0
        self.misses = 0
        self.builds = 0  # builder launches
        self.evictions = 0  # slots reused for another key

    def arena(self) -> tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            self._wait_written()
            return self._arena, self._arena_ok

    def _mark_written(self) -> None:
        """Record where the arena's last write ended on its stream (CUDA):
        a launch on another stream waits for it. Caller holds the lock or
        owns the cache."""
        if self.device.type == "cuda":
            self._written = torch.cuda.Event()
            self._written.record(torch.cuda.current_stream(self.device))

    def _wait_written(self) -> None:
        """Make the current stream wait for the arena's last write."""
        if self._written is not None:
            torch.cuda.current_stream(self.device).wait_event(self._written)

    def _build(self, keys: list[bytes]):
        """Decompress and expand ``keys`` on the device (X1):
        (tables (16, 4, 20, m), ok (m,)). Malformed keys build from zero
        bytes and get ok False."""
        m = len(keys)
        buf = np.zeros((32, m), np.uint8)
        wellformed = np.array([len(pk) == 32 for pk in keys], bool)
        for j, pk in enumerate(keys):
            if wellformed[j]:
                buf[:, j] = np.frombuffer(pk, np.uint8)
        bits = _dev_le_bits(_to_device(buf, self.device).to(torch.int32))
        libdevstats.record_h2d(buf.nbytes)
        tables, oks = cuda_verify.build_pubkey_tables(
            _dev_y_limbs(bits), bits[255].contiguous()
        )
        return tables, oks & _to_device(wellformed, self.device)

    def lookup(self, pubkeys):
        """Per-pubkey uint16 slots into the arena, building misses.

        Returns (idxs (N,) uint16, arena, arena_ok), or None when the
        call's unique keys exceed the arena. Keys used by this call are
        pinned: eviction never frees a slot this call reads. The builder
        launch runs outside the lock; slot assignment, the scatter and the
        (idxs, arena, arena_ok) capture happen under one lock hold.
        Tables are a pure function of the key, so two threads racing to
        build one key scatter identical values.
        """
        keys = [bytes(pk) for pk in pubkeys]
        in_use = set(keys)
        if len(in_use) > self.capacity:
            return None
        built: list[tuple[list[bytes], torch.Tensor, torch.Tensor]] = []
        built_keys: set[bytes] = set()
        # Bounded: under sustained churn (concurrent callers with disjoint
        # key sets larger than the arena) give up after three builds.
        for attempt in range(4):
            with self._lock:
                to_build = [
                    pk for pk in dict.fromkeys(keys)
                    if pk not in self._slots and pk not in built_keys
                ]
                if not to_build:
                    for batch_keys, tables, oks in built:
                        self._scatter(self._assign(batch_keys, in_use),
                                      tables, oks)
                    self._wait_written()
                    idxs = np.empty(len(keys), np.uint16)
                    for i, pk in enumerate(keys):
                        idxs[i] = self._slots[pk]
                        self._slots.move_to_end(pk)
                        if pk in built_keys:
                            self.misses += 1
                        else:
                            self.hits += 1
                    return idxs, self._arena, self._arena_ok
            if attempt == 3:
                break
            self.builds += 1
            tables, oks = self._build(to_build)
            built.append((to_build, tables, oks))
            built_keys.update(to_build)
        return None

    def _assign(self, batch_keys, in_use) -> np.ndarray:
        """Slots for ``batch_keys``: a key's own, else a free one, else
        the oldest key's that this call does not use. Caller holds the
        lock."""
        slots = np.empty(len(batch_keys), np.int64)
        for j, pk in enumerate(batch_keys):
            slot = self._slots.get(pk)
            if slot is None:
                if len(self._slots) >= self.capacity:
                    # evict the oldest key this call does not use
                    old = next(k for k in self._slots if k not in in_use)
                    slot = self._slots.pop(old)
                    self.evictions += 1
                else:
                    slot = len(self._slots)
                self._slots[pk] = slot
            slots[j] = slot
        return slots

    def _scatter(self, slots: np.ndarray, tables, oks) -> None:
        """Write ``tables`` and ``oks`` at ``slots`` of a new arena (X2).
        Caller holds the lock."""
        idx = _to_device(slots, self.device)
        self._arena = self._arena.index_copy(3, idx, tables)
        self._arena_ok = self._arena_ok.index_copy(0, idx, oks)
        cuda_verify.count_op("x2_scatter", idx)
        self._mark_written()

    def load(self, slots: dict[bytes, int], arena: torch.Tensor,
             arena_ok: torch.Tensor) -> None:
        """Adopt an arena and its slot map (convert.py carries one over)."""
        shape = (curve.TSIZE, 4, field.NLIMB, self.capacity + 1)
        if tuple(arena.shape) != shape or tuple(arena_ok.shape) != shape[-1:]:
            raise ValueError(f"arena must be {shape}, ok ({shape[-1]},)")
        # slots fill 0, 1, 2, ... in order (see _assign)
        if sorted(slots.values()) != list(range(len(slots))) or len(
            slots
        ) > self.capacity:
            raise ValueError("slots must be 0..k-1 with k <= capacity")
        with self._lock:
            self._arena = arena.to(self.device, torch.int32).contiguous()
            self._arena_ok = arena_ok.to(self.device, torch.bool).contiguous()
            self._slots = OrderedDict(
                sorted(slots.items(), key=lambda kv: kv[1])
            )
            self._mark_written()


# The process-wide caches, one per device, made at first use: the
# reference's module-level _PUBKEY_CACHE (cometbft_tpu/ops/verify.py:852),
# which verify_batch reads unless COMETBFT_TPU_PUBKEY_CACHE is "0".
_PUBKEY_CACHE: dict[torch.device, PubkeyTableCache] = {}
_PUBKEY_CACHE_LOCK = threading.Lock()


def _cache_enabled() -> bool:
    """COMETBFT_TPU_PUBKEY_CACHE, read at each call: anything but "0"
    (the default "1") routes cache-less batches through the process-wide
    cache."""
    return os.environ.get("COMETBFT_TPU_PUBKEY_CACHE", "1") != "0"


def pubkey_cache(device="cuda") -> PubkeyTableCache:
    """The process-wide :class:`PubkeyTableCache` of ``device``."""
    dev = resolve_device(device)
    with _PUBKEY_CACHE_LOCK:
        cache = _PUBKEY_CACHE.get(dev)
        if cache is None:
            cache = _PUBKEY_CACHE[dev] = PubkeyTableCache(dev)
        return cache


def prestage_pubkeys(pubkeys, device="cuda") -> int:
    """Warm the process-wide arena of ``device`` with ``pubkeys`` (at most
    its capacity), so the next commit over them ships only R|S|k and runs
    K2 with no builder launch. Returns the builder launches this took (0:
    already staged, or nothing to do).

    COMETBFT_TPU_PRESTAGE: "auto" (the default) warms only a CUDA device,
    "1" forces a warm-up (the CPU tests), "0" disables it; so does
    COMETBFT_TPU_PUBKEY_CACHE=0. Unlike the reference (which returns 0 on
    any exception), a failed warm-up raises.
    """
    mode = os.environ.get("COMETBFT_TPU_PRESTAGE", "auto")
    if mode == "0" or not _cache_enabled():
        return 0
    if mode != "1" and torch.device(device).type != "cuda":
        return 0
    keys = [bytes(pk) for pk in pubkeys][: PubkeyTableCache.CAPACITY]
    if not keys:
        return 0
    cache = pubkey_cache(device)
    before = cache.builds
    cache.lookup(keys)
    return cache.builds - before


# ---------------------------------------------------------------- launches


def _stage(lanes, kind: str, arr: np.ndarray, dev) -> torch.Tensor:
    """``arr`` on ``dev``: through ``lanes`` (a LaneArena) when given,
    else a plain copy."""
    if lanes is None:
        return _to_device(arr, dev)
    if lanes.device != dev:
        raise ValueError(f"lane arena lives on {lanes.device}, not {dev}")
    return lanes.stage(kind, arr)


def verify_bytes_async(buf: np.ndarray, n: int, device="cuda", flavor=None,
                       lanes: LaneArena | None = None):
    """Launch the uncached kernel (K1, or K3 with ``flavor`` "8") on packed
    (128, n) wire rows, on the current stream.

    Returns a zero-arg closure that reads back the (n,) validity bitmap,
    so host work can overlap the kernel. Batches past _CHUNK split into
    _CHUNK-lane launches. ``lanes`` stages the rows through that
    :class:`LaneArena` instead of a fresh copy.
    """
    dev = resolve_device(device)
    flavor = kernel_flavor(flavor)
    if n > _CHUNK:
        finals = [
            verify_bytes_async(buf[:, lo : min(lo + _CHUNK, n)],
                               min(lo + _CHUNK, n) - lo, dev, flavor, lanes)
            for lo in range(0, n, _CHUNK)
        ]
        return lambda: np.concatenate([f() for f in finals])
    kernel = (cuda_verify.verify_kernel8 if flavor == "8"
              else cuda_verify.verify_kernel)
    wire = _stage(lanes, "wire", buf, dev)
    libdevstats.record_h2d(buf.nbytes)
    ok = kernel(**unpack_on_device(wire, flavor))
    return _readback(ok, bucket_size(n))


def verify_rsk_async(buf: np.ndarray, idxs: np.ndarray, arena, arena_ok,
                     n: int, flavor=None, lanes: LaneArena | None = None):
    """Launch the cached kernel (K2, or K4 with ``flavor`` "8"): (96, n)
    R|S|kneg rows plus uint16 arena slots. Same async contract as
    :func:`verify_bytes_async`; ``n`` must be <= _CHUNK."""
    dev = arena.device
    flavor = kernel_flavor(flavor)
    if dev.type == "cuda":
        # the arena may have been made on another stream: the allocator
        # must not reuse it before this stream's kernel has read it
        stream = torch.cuda.current_stream(dev)
        arena.record_stream(stream)
        arena_ok.record_stream(stream)
    # uint16 slots travel as int16 (2 B/lane); the kernel reads uint16
    slots = np.asarray(idxs, np.uint16).view(np.int16)
    slot_dev = _stage(lanes, "idx", slots, dev)
    rsk = _stage(lanes, "rsk", buf, dev)
    libdevstats.record_h2d(buf.nbytes + slots.nbytes)
    kernel = (cuda_verify.verify_kernel8_cached if flavor == "8"
              else cuda_verify.verify_kernel_cached)
    ok = kernel(arena, arena_ok, **_unpack_rsk_on_device(rsk, flavor),
                idxs=slot_dev)
    return _readback(ok, bucket_size(n))


def verify_prepacked(buf: np.ndarray, keys, n: int, *, device="cuda",
                     cache: PubkeyTableCache | None = None, flavor=None):
    """Launch the verify kernels on pre-packed (128, n) wire rows, routed
    through the pubkey arena as :func:`verify_batch` routes: K2 (K4 with
    ``flavor`` "8") on a cache hit, K1 (K3) with no cache or when the keys
    overflow the arena. Returns the closure that reads back the (n,)
    device verdicts.

    ``keys``: each lane's 32-byte Edwards A encoding, the arena's key. For
    schemes that pack their own challenge (sr25519: a merlin transcript's
    k, crypto/sr25519.py) and share the cofactored kernels and the arena,
    keyed by the Edwards encoding itself, so a converted sr25519 key and an
    ed25519 key of the same point share a slot. A lane the host rejected
    carries key b"" and a zero row: its slot's ok bit is False, but a zero
    row uncached decodes to a small-order point the cofactored equation
    accepts, so every caller ANDs its host checks into the verdicts.
    """
    dev = resolve_device(device)
    flavor = kernel_flavor(flavor)
    if cache is not None and cache.device != dev:
        raise ValueError(f"cache lives on {cache.device}, not {dev}")
    if buf.shape != (128, n) or len(keys) != n:
        raise ValueError(f"buf must be (128, {n}) with {n} keys")
    if n == 0:
        return lambda: np.zeros(0, bool)
    if cache is None and _cache_enabled():
        cache = pubkey_cache(dev)
    finals = []
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        hit = cache.lookup(keys[lo:hi]) if cache is not None else None
        if hit is not None:
            idxs, arena, arena_ok = hit
            finals.append(verify_rsk_async(buf[32:, lo:hi], idxs, arena,
                                           arena_ok, hi - lo, flavor))
        else:
            finals.append(verify_bytes_async(buf[:, lo:hi], hi - lo, dev,
                                             flavor))
    if len(finals) == 1:
        return finals[0]
    return lambda: np.concatenate([f() for f in finals])


def _shard_devices(device, cache=None):
    """The CUDA devices to shard a :func:`verify_batch` call over, or None
    for the single-device route.

    COMETBFT_TPU_SHARD, read at each call: "0" never shards; "auto" (the
    default) and "1" shard when the call's device is CUDA and the process
    sees two or more CUDA devices (libs/accel, probed once). Any other
    value raises. A call that names a ``cache`` keeps the single-device
    route: that arena lives on one device. Unlike the reference, "1" does
    not shard over host devices: the CPU runs the plain versions only.
    """
    mode = os.environ.get("COMETBFT_TPU_SHARD", "auto")
    if mode not in ("0", "1", "auto"):
        raise ValueError(
            f"COMETBFT_TPU_SHARD={mode!r}: expected '0', '1' or 'auto'")
    if mode == "0" or cache is not None:
        return None
    if torch.device(device).type != "cuda":
        return None
    count = libaccel.cuda_device_count()
    if count < 2:
        return None
    return [torch.device("cuda", i) for i in range(count)]


def _verify_batch_sharded(pubkeys, msgs, sigs, n_dev: int, mesh=None):
    """One flat batch over the signature axis of ``mesh`` (default: every
    CUDA device, parallel/mesh.default_mesh): (all_valid, (n,) bool).

    The lanes pad to n_dev x a power of two (at least _MIN_BUCKET per
    device), host_ok with False, and the limb arrays of
    :func:`pack_inputs` go to parallel/mesh.verify_sharded as one commit.
    K1 runs once a mesh entry whatever the ``flavor``: the 8-bit kernels
    take S as bytes, which pack_inputs does not ship."""
    from ..parallel import mesh as pmesh

    if mesh is None:
        mesh = pmesh.default_mesh()
    n = len(pubkeys)
    t0 = time.perf_counter()
    arrays, host_ok = pack_inputs(pubkeys, msgs, sigs)
    per_dev = _MIN_BUCKET
    while per_dev * n_dev < n:
        per_dev *= 2
    nb = per_dev * n_dev
    if nb != n:
        arrays = {
            k: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, nb - n)])
            for k, v in arrays.items()
        }
        host_ok = np.pad(host_ok, (0, nb - n))
    t1 = time.perf_counter()
    libmetrics.observe_verify_phase("pack", "ed25519-tpu", t1 - t0, n,
                                    arena="sharded")
    ok = pmesh.verify_sharded(arrays, host_ok, mesh, 1, nb)[0][:n]
    # every shard is read back inside verify_sharded: dispatch and
    # readback are one phase on this route, as in the reference
    libmetrics.observe_verify_phase("dispatch", "ed25519-tpu",
                                    time.perf_counter() - t1, n,
                                    arena="sharded")
    return bool(ok.all()), ok


def verify_batch(pubkeys, msgs, sigs, *, device="cuda",
                 cache: PubkeyTableCache | None = None, flavor=None):
    """Verify a batch of ed25519 signatures on ``device``.

    Returns (all_valid, per-signature validity (n,) bool): the contract of
    crypto.BatchVerifier.Verify (crypto/crypto.go:45-54) with per-lane
    results. The steady state ships (R, S, -k) plus a slot per lane and
    runs K2 against ``cache`` or, when None, the process-wide cache of
    ``device`` (:func:`pubkey_cache`); with COMETBFT_TPU_PUBKEY_CACHE=0 and
    no ``cache``, or when the call's keys overflow the arena, the full wire
    rows go to K1. ``flavor`` "8" runs K4 and K3
    in their places (see :func:`kernel_flavor`). Every verdict is ANDed
    with the host checks: a zeroed malformed lane decodes to a small-order
    point the cofactored equation would accept.

    With two or more CUDA devices (:func:`_shard_devices`) the batch is
    sharded over all of them instead, K1 once a device
    (:func:`_verify_batch_sharded`). The phases go to
    ``crypto_verify_phase_seconds`` and ``verify.*`` trace events, with
    the arena's disposition (hit, miss, bypass, off or sharded).
    """
    dev = resolve_device(device)
    flavor = kernel_flavor(flavor)
    if cache is not None and cache.device != dev:
        raise ValueError(f"cache lives on {cache.device}, not {dev}")
    n = len(pubkeys)
    if n == 0:
        return True, np.zeros(0, bool)
    devs = _shard_devices(dev, cache)
    if devs is not None:
        return _verify_batch_sharded(pubkeys, msgs, sigs, len(devs))
    if cache is None and _cache_enabled():
        cache = pubkey_cache(dev)
    finals, host_oks = [], []
    # pack = host staging with the arena lookup (a miss's builder launch
    # included), dispatch = the launches, readback = reading the verdicts;
    # summed over chunks, they tile the call
    pack_s = disp_s = 0.0
    arena_state = "hit" if cache is not None else "off"
    builds_before = cache.builds if cache is not None else 0
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        tp = time.perf_counter()
        buf, hok = pack_bytes(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi])
        hit = cache.lookup(pubkeys[lo:hi]) if cache is not None else None
        td = time.perf_counter()
        pack_s += td - tp
        if hit is not None:
            idxs, arena, arena_ok = hit
            finals.append(verify_rsk_async(buf[32:], idxs, arena, arena_ok,
                                           hi - lo, flavor))
        else:
            if cache is not None:
                arena_state = "bypass"  # the keys overflowed the arena
            finals.append(verify_bytes_async(buf, hi - lo, dev, flavor))
        disp_s += time.perf_counter() - td
        host_oks.append(hok)
    if arena_state == "hit" and cache.builds > builds_before:
        arena_state = "miss"  # the lookup had to build tables
    tr = time.perf_counter()
    device_ok = np.concatenate([f() for f in finals])
    read_s = time.perf_counter() - tr
    for phase, seconds in (("pack", pack_s), ("dispatch", disp_s),
                           ("readback", read_s)):
        libmetrics.observe_verify_phase(phase, "ed25519-tpu", seconds, n,
                                        arena=arena_state)
    valid = device_ok & np.concatenate(host_oks)
    return bool(valid.all()), valid
