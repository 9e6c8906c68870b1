"""Cross-caller hash coalescer: the device SHA-256 plane.

Port of cometbft_tpu/crypto/hashplane.py. Concurrent callers (PartSet leaf
hashing on the build and the gossip side, merkle levels, Data.hash's tx
keys) submit message lanes and block on a ticket; an executor thread
flushes windows by size (``max_lanes``) or by a deadline proportional to
the host cost of the pending work (capped by ``window_us``), splits each
window by SHA block bucket (a 33-byte merkle leaf must not pad to a
64 KiB part's block count) and launches each bucket through
ops/sha256.sha256_many_async on the plane's own CUDA stream. A readback
drain thread materializes dispatched windows in order, each behind its
own event, while the executor packs the next one; ``max_inflight``
bounds that pipeline. The executor, drain and lifecycle are
crypto/plane.WindowPlane's, which the verify coalescer shares.

Routing, as in the reference: with no plane pushed (:func:`push_active`)
hashing is unrouted and runs hashlib; a batch below its block bucket's
device cut (``batch_worth_routing``, the seed curve ``max(2, 2048 //
bucket)`` lanes, adapted per bucket on CUDA) hashes inline with hashlib,
as does a bucket of a window below its cut. The cuts are process-wide per
device, as the reference's module-level ``CROSSOVER`` is: every plane on
a device reads and feeds one :class:`_BucketCrossover`
(:func:`crossover`), so a new plane starts from the cut the planes before
it calibrated. Digests are bit-identical either way.

No fallback, unlike the reference: a device fault (at dispatch or at
readback) or a ticket that outlives its wait fails the tickets of its
window, and the routed helpers raise to their caller. Nothing is hashed
on the host to cover for the device. Stopping drains the pending windows
through the plane's device and fails what a dead executor left. A
request deadline (crypto/plane.request_deadline) that has passed raises
TimeoutError, as in the verify coalescer.

Knobs, as in the reference: ``COMETBFT_TPU_HASH_WINDOW_US``,
``COMETBFT_TPU_HASH_MAX_LANES`` (clamped to the kernel's per-launch
cap), ``COMETBFT_TPU_HASH_MIN_DEVICE_LANES`` and
``COMETBFT_TPU_HASH_INFLIGHT``; a constructor argument wins.

Reports, as the reference makes them: every window observes
``crypto_hash_window_lanes`` and ``crypto_hash_flush_total{reason}``, its
buckets' dispatch, readback or fallback (inline hashlib) phases
(``observe_hash_phase``), and a ``hash.flush`` trace event; each ticket
is charged to its caller class in the device-time ledger (libs/devledger)
with the window's device bucket time and its inline bucket time split
apart, so a mixed window charges its device share and its host share
separately; FSM-adjacent callers (merkle, mempool) leave an EV_BUDGET row
and every window an EV_HASH row (lanes, device flag) in the flight ring.

``device="cpu"`` runs the plain PyTorch version through the same windows
(the tests' path); the default ``"cuda"`` raises without a GPU.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

import torch

from ..libs import devledger as libdevledger
from ..libs import health as libhealth
from ..libs import metrics as libmetrics
from ..libs import sync as libsync
from ..libs import trace as libtrace
from ..libs.service import ServiceError
from ..ops import cuda_sha256
from ..ops import sha256 as osha
from ..ops.verify import resolve_device
from . import batch as crypto_batch
from .plane import WindowPlane, knob

# Deadline window before a sub-size window flushes anyway.
_DEFAULT_WINDOW_US = 500
# Lanes that trigger a size flush, and the per-window cap.
_DEFAULT_MAX_LANES = 2048
# Dispatched windows waiting for readback before the executor blocks.
_DEFAULT_MAX_INFLIGHT = 2
# Ticket wait bound for the routed helpers; past it they raise.
_RESULT_TIMEOUT_S = 5.0

# Routed-helper floors: hash_bytes routes single messages of at least this
# many bytes; hash_many routes batches of at least this many padded blocks.
_SUM_ROUTE_MIN_BYTES = 1024
_ROUTE_MIN_BLOCKS = 64
# Seed of the per-bucket device cut: a window wins on the device once it
# carries ~this many SHA blocks, so bucket B's cut is max(2, SEED // B).
_SEED_DEVICE_BLOCKS = 2048

# The deadline a window waits for more lanes: at most ~2x the host hashlib
# cost of the work already pending (capped by the window knob), so a lone
# small message does not sit out the whole window.
_HOST_S_PER_BLOCK = 25e-9  # single-core hashlib cost per 64-byte block
_WAIT_COST_FACTOR = 2.0


class HashplaneStoppedError(ServiceError):
    """submit() after the drain began, or a ticket the plane stopped
    before its window ran."""


class _Inflight:
    """A window whose device buckets are dispatched, not yet read back."""

    __slots__ = ("finishes", "out", "staged", "msgs", "reason", "t_launch",
                 "host_s")

    def __init__(self, finishes, out, staged, msgs, reason, t_launch,
                 host_s):
        # [(materializer, window indices, block bucket, dispatch seconds)]
        self.finishes = finishes
        self.out = out  # window-ordered digests (host buckets filled)
        self.staged = staged  # [(ticket, first window index)]
        self.msgs = msgs  # the window's messages, in window order
        self.reason = reason  # why the window flushed
        self.t_launch = t_launch  # its pop: the tickets' queue-wait anchor
        self.host_s = host_s  # its inline (hashlib) buckets' seconds


def fl_msg(fl: _Inflight, i: int) -> bytes:
    """Window-ordered message i of an in-flight window."""
    return fl.msgs[i]


class _BucketCrossover:
    """Per-block-bucket host/device lane cut of one device.

    One crypto.batch.AdaptiveCrossover per SHA block bucket, fed from the
    windows of every plane on the device: ``threshold(bucket)`` says at how
    many lanes a window of that message size goes to the device. Until a
    bucket is calibrated, and always while adaptation is off for the
    device (crypto.batch._adaptive_enabled, read at each call as the
    reference reads it), the seed ``max(2, 2048 // bucket)`` answers.
    """

    def __init__(self, device) -> None:
        self._device = device
        self._mtx = libsync.Mutex("crypto.hashplane._crossover")
        self._fits: dict[int, crypto_batch.AdaptiveCrossover] = {}

    def _adaptive(self) -> bool:
        return crypto_batch._adaptive_enabled(self._device)

    def _fit(self, bucket: int) -> crypto_batch.AdaptiveCrossover:
        with self._mtx:
            xo = self._fits.get(bucket)
            if xo is None:
                xo = self._fits[bucket] = crypto_batch.AdaptiveCrossover()
            return xo

    def note_host(self, bucket: int, lanes: int, seconds: float) -> None:
        if self._adaptive():
            self._fit(bucket).observe_host(lanes, seconds)

    def note_device(self, bucket: int, lanes: int, seconds: float) -> None:
        if self._adaptive():
            self._fit(bucket).observe_device(lanes, seconds)

    def threshold(self, bucket: int) -> int:
        seed = max(2, _SEED_DEVICE_BLOCKS // max(1, bucket))
        if not self._adaptive():
            return seed
        t = self._fit(bucket).threshold()
        return seed if t is None else t


# The process-wide crossovers, one per device, made at first use.
_CROSSOVERS: dict[torch.device, _BucketCrossover] = {}
_CROSSOVERS_LOCK = threading.Lock()


def crossover(device) -> _BucketCrossover:
    """The process-wide :class:`_BucketCrossover` of ``device``, which
    every plane on it reads and feeds."""
    dev = resolve_device(device)
    with _CROSSOVERS_LOCK:
        xo = _CROSSOVERS.get(dev)
        if xo is None:
            xo = _CROSSOVERS[dev] = _BucketCrossover(dev)
        return xo


def reset_crossovers() -> None:
    """Forget every device's calibrated cuts. For tests only: they need a
    clean start; a running node keeps what its planes have learned."""
    with _CROSSOVERS_LOCK:
        _CROSSOVERS.clear()


class HashCoalescer(WindowPlane):
    """Background hash executor coalescing concurrent digest callers on
    ``device`` (see the module docstring and crypto/plane.py)."""

    STOPPED_ERROR = HashplaneStoppedError
    LEDGER_PLANE = libdevledger.PLANE_HASH

    def __init__(
        self,
        window_us: int | None = None,
        max_lanes: int | None = None,
        min_device_lanes: int | None = None,
        device="cuda",
        max_inflight: int | None = None,
    ):
        super().__init__(
            "HashCoalescer", "crypto.hashplane", device,
            knob(window_us, "COMETBFT_TPU_HASH_WINDOW_US",
                 _DEFAULT_WINDOW_US) / 1e6,
            # clamped to the kernel's per-launch cap
            min(osha.MAX_LANES, knob(max_lanes, "COMETBFT_TPU_HASH_MAX_LANES",
                                     _DEFAULT_MAX_LANES)),
            knob(max_inflight, "COMETBFT_TPU_HASH_INFLIGHT",
                 _DEFAULT_MAX_INFLIGHT),
        )
        # None defers to the per-bucket crossover at flush time
        self.min_device_lanes = knob(
            min_device_lanes, "COMETBFT_TPU_HASH_MIN_DEVICE_LANES", None)
        self.crossover = crossover(self.device)
        # lanes hashed on the device, with hashlib inside windows, and
        # with hashlib inline by the routed helpers (below their cut)
        self.device_lanes = 0
        self.host_lanes = 0
        self.inline_lanes = 0

    def _prepare(self) -> None:
        if self.device.type == "cuda":
            cuda_sha256.load()

    def _group_size(self, msgs) -> tuple[int, int]:
        try:
            blocks = sum(osha.n_blocks(len(m)) for m in msgs)
        except TypeError:
            blocks = 0  # unsized lanes fail in _stage, per ticket
        return len(msgs), blocks

    def _window_budget(self) -> float:
        """min(window, ~2x the pending lanes' host hashlib cost)."""
        return min(self.window_s, _WAIT_COST_FACTOR * _HOST_S_PER_BLOCK
                   * self._pending_weight)

    # -- submission --------------------------------------------------------

    def submit(self, msgs):
        """Queue message lanes; returns the ticket with their digests.
        Raises :class:`HashplaneStoppedError` once the drain began."""
        return self.submit_many([msgs])[0]

    def try_hash_many(self, msgs) -> list[bytes]:
        """Submit and wait: the digests of ``msgs``, chunked into
        ``max_lanes`` tickets submitted as one batch. Raises the fault of
        a failed window, TimeoutError past the wait bound and
        :class:`HashplaneStoppedError` on a stopped plane: it never
        answers from the host in the device's place."""
        n = len(msgs)
        groups = [msgs[i : i + self.max_lanes]
                  for i in range(0, n, self.max_lanes)] or [msgs]
        return self._submit_and_wait(groups, _RESULT_TIMEOUT_S)

    def batch_worth_routing(self, msgs) -> bool:
        """True when this batch alone puts at least one of its block
        buckets over that bucket's device cut, and carries the minimum
        total work. Single messages (:func:`hash_bytes`) do not ask: they
        queue hoping for concurrent company."""
        counts: dict[int, int] = {}
        total = 0
        for m in msgs:
            nb = osha.n_blocks(len(m))
            total += nb
            bb = osha.block_bucket(nb)
            counts[bb] = counts.get(bb, 0) + 1
        if total < _ROUTE_MIN_BLOCKS:
            return False
        return any(c >= self._device_cut(bb) for bb, c in counts.items())

    def note_inline(self, lanes: int) -> None:
        """Count lanes a routed helper hashed inline, below their cut."""
        with self._mtx:
            self.inline_lanes += lanes

    # -- windows -----------------------------------------------------------

    def _device_cut(self, bucket: int) -> int:
        """Lane cut of a block bucket: the constructor's pin, else the
        bucket's crossover."""
        if self.min_device_lanes is not None:
            return self.min_device_lanes
        return self.crossover.threshold(bucket)

    def _stage(self, groups):
        """Flatten groups into one window-ordered message list; a lane
        that cannot coerce to bytes fails only its own ticket."""
        msgs: list[bytes] = []
        staged: list[tuple] = []  # (ticket, first window index)
        for ticket, raw in groups:
            try:
                lanes = [bytes(m) for m in raw]
                if len(lanes) != ticket.n:
                    raise ValueError(
                        f"lane count mismatch: {len(lanes)} != {ticket.n}")
            except Exception as e:
                ticket.fail(e)
                continue
            staged.append((ticket, len(msgs)))
            msgs.extend(lanes)
        return msgs, staged

    def _launch(self, groups, reason, t_pop) -> _Inflight | None:
        """Stage and dispatch one window, split by block bucket. Buckets
        at their device cut dispatch asynchronously on the plane's stream;
        the others hash inline with hashlib. Returns the in-flight window
        when a device bucket launched, else resolves it here."""
        msgs, staged = self._stage(groups)
        if not staged:
            return None
        n = len(msgs)
        m = libmetrics.node_metrics()
        m.hash_window_lanes.observe(n)
        m.hash_flushes.labels(reason).inc()
        self.windows += 1
        buckets: dict[int, list[int]] = {}
        for i, msg in enumerate(msgs):
            bb = osha.block_bucket(osha.n_blocks(len(msg)))
            buckets.setdefault(bb, []).append(i)
        out: list[bytes | None] = [None] * n
        finishes = []
        host_s = 0.0
        for bb in sorted(buckets):
            idxs = buckets[bb]
            sub = [msgs[i] for i in idxs]
            t0 = time.perf_counter()
            if len(idxs) >= self._device_cut(bb):
                with torch.cuda.stream(self._stream):
                    finish = osha.sha256_many_async(sub, bb,
                                                    device=self.device)
                prep = time.perf_counter() - t0
                libmetrics.observe_hash_phase("dispatch", prep, len(idxs))
                finishes.append((finish, idxs, bb, prep))
                self.device_lanes += len(idxs)
                continue
            for i, msg in zip(idxs, sub):
                out[i] = hashlib.sha256(msg).digest()
            dt = time.perf_counter() - t0
            host_s += dt
            libmetrics.observe_hash_phase("fallback", dt, len(idxs))
            self.crossover.note_host(bb, len(idxs), dt)
            self.host_lanes += len(idxs)
        if finishes:
            self.device_windows += 1
            self._note_window(n, True)
            return _Inflight(finishes, out, staged, msgs, reason, t_pop,
                             host_s)
        self._note_window(n, False)
        self._resolve_bits(staged, out, reason, "host", t_pop, 0.0, host_s)
        return None

    def _finish(self, fl: _Inflight) -> None:
        """Read back a window's device buckets and resolve its tickets."""
        mark = self._readback_mark()
        device_s = 0.0
        for finish, idxs, bb, prep in fl.finishes:
            t0 = time.perf_counter()
            digests = finish()
            dt = time.perf_counter() - t0
            device_s += prep + dt
            libmetrics.observe_hash_phase("readback", dt, len(idxs))
            self.crossover.note_device(bb, len(idxs), prep + dt)
            for j, i in enumerate(idxs):
                fl.out[i] = digests[j]
        self._note_readback(mark)
        self._resolve_bits(fl.staged, fl.out, fl.reason, "device",
                           fl.t_launch, device_s, fl.host_s)

    def _resolve_bits(self, staged, out, reason, backend, t_launch, exec_s,
                      host_s) -> None:
        """Resolve a window's tickets, then charge them. ``exec_s`` is the
        window's device bucket time (dispatch and readback), ``host_s``
        its inline hashlib bucket time; each ticket takes a share of both
        by lanes, apart, so a mixed window never reports host work as
        device time. The ledger block rides the ledger's switch."""
        self._resolve(staged, out)
        total = sum(ticket.n for ticket, _ in staged)
        if libdevledger.enabled():
            m = libmetrics.node_metrics()
            plane = self.LEDGER_PLANE
            exec_ns = int(exec_s * 1e9)
            host_ns = int(host_s * 1e9)
            if exec_ns + host_ns > 0:
                libdevledger.note_window_time(plane, exec_ns + host_ns)
            bw = bx = 0  # FSM-adjacent (merkle, mempool) wait and execute
            for ticket, _ in staged:
                wait_ns = max(0, int((t_launch - ticket.t_submit) * 1e9))
                dev_share = exec_ns * ticket.n // total
                host_share = host_ns * ticket.n // total
                cid = ticket.caller
                libdevledger.note_resolve(plane, cid, ticket.n, wait_ns,
                                          dev_share, host_share)
                m.device_queue_wait.labels(
                    "hash", libdevledger.caller_name(cid)).observe(
                        wait_ns / 1e9)
                if cid in libdevledger.BUDGET_HASH_CALLERS:
                    bw += wait_ns
                    bx += dev_share + host_share
            if bw or bx:
                libhealth.record(libhealth.EV_BUDGET, 0, plane, bw, bx)
        if libhealth.enabled():
            libhealth.record(libhealth.EV_HASH, a=total,
                             b=1 if backend == "device" else 0)
        if libtrace.enabled():
            libtrace.event("hash.flush", reason=reason, backend=backend,
                           lanes=total, tickets=len(staged))


# -- process-wide routing switch ------------------------------------------

_ACTIVE: list[HashCoalescer] = []
_ACTIVE_LOCK = threading.Lock()


def push_active(co: HashCoalescer) -> None:
    """Install ``co`` as the process-wide routed hash plane."""
    with _ACTIVE_LOCK:
        _ACTIVE.append(co)


def pop_active(co: HashCoalescer) -> None:
    with _ACTIVE_LOCK:
        for i in range(len(_ACTIVE) - 1, -1, -1):
            if _ACTIVE[i] is co:
                del _ACTIVE[i]
                return


def active() -> HashCoalescer | None:
    """The routed plane, or None when hashing is unrouted."""
    with _ACTIVE_LOCK:
        planes = tuple(_ACTIVE)
    for co in reversed(planes):
        if co.routable():
            return co
    return None


def configured_mode() -> str:
    """COMETBFT_TPU_HASH: "auto" (the default), "on" ("1", "on", "true",
    "yes") or "off" ("0", "off", "false", "no")."""
    v = os.environ.get("COMETBFT_TPU_HASH", "auto").lower()
    if v in ("1", "on", "true", "yes"):
        return "on"
    if v in ("0", "off", "false", "no"):
        return "off"
    return "auto"


def node_wants_hashplane() -> bool:
    """Whether a node should start a HashCoalescer: forced by
    COMETBFT_TPU_HASH on or off, else (auto) when CUDA is there."""
    mode = configured_mode()
    if mode != "auto":
        return mode == "on"
    from ..libs.accel import accelerator_backend

    return accelerator_backend()


def prewarm() -> bool:
    """Push one tiny window through the routed plane, so its kernel and
    buffers are resident before the next height needs them. True when a
    window ran, False when hashing is unrouted; a fault raises."""
    co = active()
    if co is None:
        return False
    co.submit([b"\x00" * 64] * 4).result(_RESULT_TIMEOUT_S)
    return True


def hash_bytes(bz: bytes) -> bytes:
    """Single-message SHA-256 (``tmhash.sum``), queued on the routed plane
    from :data:`_SUM_ROUTE_MIN_BYTES` up; hashlib when unrouted or below."""
    if len(bz) >= _SUM_ROUTE_MIN_BYTES:
        co = active()
        if co is not None:
            return co.try_hash_many([bz])[0]
    return hashlib.sha256(bz).digest()


def hash_many(msgs) -> list[bytes]:
    """Batch SHA-256 over independent messages: on the routed plane when
    the batch can win there (``batch_worth_routing``), else hashlib."""
    if msgs:
        co = active()
        if co is not None:
            if co.batch_worth_routing(msgs):
                return co.try_hash_many(msgs)
            co.note_inline(len(msgs))
    return [hashlib.sha256(bytes(m)).digest() for m in msgs]
