"""Cross-caller verify coalescer: micro-batched device launches for the
steady-state vote path.

Port of cometbft_tpu/crypto/coalesce.py. An individually gossiped vote
carries one signature, which alone never crosses the host/device cut
(crypto/batch.host_batch_threshold). Concurrent callers — vote admission
(types/vote.py, types/vote_set.py), commit checks that verify signature by
signature (types/validation._verify_single) and batch verifiers below the
cut (crypto/batch.py) — submit signature lanes and block on a ticket; the
executor (crypto/plane.WindowPlane, shared with the hash plane) flushes
windows by size (``max_lanes``, COMETBFT_TPU_COALESCE_MAX_LANES) or by a
deadline (``window_us``, COMETBFT_TPU_COALESCE_WINDOW_US).

A window at or above its device cut (``min_device_lanes``,
COMETBFT_TPU_COALESCE_MIN_DEVICE_LANES, else the live cut of the device)
packs its lanes natively (ops/verify.pack_bytes), looks its keys up in the
device's process-wide pubkey arena (ops/verify.pubkey_cache) unless
COMETBFT_TPU_PUBKEY_CACHE=0, stages the rows through the coalescer's
:class:`~cometbft_tpu_torch.ops.verify.LaneArena` and launches K2
(``verify_rsk_async``) on a hit, K1 (``verify_bytes_async``) otherwise, on
the coalescer's own CUDA stream. The readback drain reads windows back in
submission order while the executor packs the next; at most
``max_inflight`` (COMETBFT_TPU_COALESCE_INFLIGHT) wait for it. A window
below its cut runs the native RLC host batch (crypto/host_batch), one MSM
for the whole window. Both kinds feed the device's crossover.

No fallback, unlike the reference: a fault at packing, launch or readback,
or in the host engine, fails the tickets of its window and the callers
raise; a ticket that outlives its wait raises TimeoutError. Nothing is
verified on the host a second time to cover for the device, and there is
no breaker. Routing stays what it is: with no coalescer pushed
(:func:`push_active`) verification is unrouted.

Request deadlines (:func:`request_deadline`, :func:`deadline_remaining`,
from crypto/plane): departure from the reference, whose ``try_verify``
returns None once the thread's deadline has passed, so that the caller
verifies on the host instead. Here ``try_verify`` raises TimeoutError
before submitting, or caps the ticket wait at the deadline and raises
TimeoutError when it runs out; it never answers from the host in the
device's place.

Reports, as the reference makes them: every window observes
``crypto_coalesce_window_lanes`` and ``crypto_coalesce_flush_total{reason}``
and its pack, dispatch, readback (device) or fallback (host window)
phases under the "ed25519-coalesce" backend; each ticket is charged to
its caller class in the device-time ledger (libs/devledger: queue wait
from submit to the window's pop, and a pro-rata share by lanes of the
window's pack+dispatch+readback time, or of its host time) and observes
``device_queue_wait_seconds{plane="verify",caller}``; consensus callers'
shares leave an EV_BUDGET row in the flight ring (libs/health); a
``coalesce.flush`` trace event closes each window.

``device="cpu"`` runs the kernels' plain PyTorch versions through the same
windows (the tests' path); the default ``"cuda"`` raises without a GPU.
"""

from __future__ import annotations

import collections
import os
import time

import torch

from ..libs import devledger as libdevledger
from ..libs import health as libhealth
from ..libs import metrics as libmetrics
from ..libs import trace as libtrace
from ..libs.service import ServiceError
from ..ops import cuda_verify
from ..ops import verify as ov
from . import batch as crypto_batch
from . import host_batch
from .keys import ED25519_KEY_TYPE
from .plane import (  # noqa: F401  (the reference's public names)
    WindowPlane,
    deadline_remaining,
    knob,
    request_deadline,
)

# Deadline window before a sub-size window flushes anyway: about an order
# of magnitude under a device window's cost, so concurrent callers pile
# into one launch at little added latency.
_DEFAULT_WINDOW_US = 500
# Lanes that trigger a size flush, and the per-window cap: a full prevote
# round of a 1,000-validator set in one launch.
_DEFAULT_MAX_LANES = 1024
# Dispatched windows waiting for readback before the executor blocks.
_DEFAULT_MAX_INFLIGHT = 2
# Ticket wait bound for the routed helpers; past it they raise.
_RESULT_TIMEOUT_S = 5.0


class CoalescerStoppedError(ServiceError):
    """submit() after the drain began, or a ticket the coalescer stopped
    before its window ran."""


class _Inflight:
    """A device window dispatched, not yet read back."""

    __slots__ = ("finish", "host_ok", "staged", "lanes", "prep_s", "reason",
                 "t_launch")

    def __init__(self, finish, host_ok, staged, lanes, prep_s, reason,
                 t_launch):
        self.finish = finish  # the readback closure of ops/verify
        self.host_ok = host_ok
        self.staged = staged  # [(ticket, first window index)]
        self.lanes = lanes
        # pack + dispatch seconds: with the readback, what the crossover
        # and the ledger charge the window (not its wall time to _finish,
        # which holds the next window's collect wait and pack)
        self.prep_s = prep_s
        self.reason = reason  # why the window flushed
        self.t_launch = t_launch  # its pop: the tickets' queue-wait anchor


class VerifyCoalescer(WindowPlane):
    """Background verify executor coalescing single-signature callers on
    ``device`` (see the module docstring and crypto/plane.py)."""

    STOPPED_ERROR = CoalescerStoppedError
    LEDGER_PLANE = libdevledger.PLANE_VERIFY

    def __init__(
        self,
        window_us: int | None = None,
        max_lanes: int | None = None,
        min_device_lanes: int | None = None,
        device="cuda",
        max_inflight: int | None = None,
    ):
        super().__init__(
            "VerifyCoalescer", "crypto.coalesce", device,
            knob(window_us, "COMETBFT_TPU_COALESCE_WINDOW_US",
                 _DEFAULT_WINDOW_US) / 1e6,
            knob(max_lanes, "COMETBFT_TPU_COALESCE_MAX_LANES",
                 _DEFAULT_MAX_LANES),
            knob(max_inflight, "COMETBFT_TPU_COALESCE_INFLIGHT",
                 _DEFAULT_MAX_INFLIGHT),
        )
        # None defers to the device's live cut at flush time
        self.min_device_lanes = knob(
            min_device_lanes, "COMETBFT_TPU_COALESCE_MIN_DEVICE_LANES", None)
        self._lanes = ov.LaneArena(self.device)
        # lanes verified on the device and on the host, and windows by
        # lane count on each
        self.device_lanes = 0
        self.host_lanes = 0
        self.window_lanes = {"device": collections.Counter(),
                             "host": collections.Counter()}

    def _prepare(self) -> None:
        host_batch.available()
        if self.device.type == "cuda":
            cuda_verify._entries()

    def _group_size(self, group) -> tuple[int, int]:
        return len(group[0]), 0

    # -- submission --------------------------------------------------------

    def submit(self, pubkeys, msgs, sigs):
        """Queue raw ed25519 lanes (32-byte key encodings, messages,
        signatures); returns the ticket with their bits. Raises
        :class:`CoalescerStoppedError` once the drain began."""
        return self.submit_many([(pubkeys, msgs, sigs)])[0]

    def try_verify(self, pubkeys, msgs, sigs) -> list[bool]:
        """Submit and wait: the per-lane bits, chunked into ``max_lanes``
        tickets submitted as one batch and reassembled in order. Raises
        the fault of a failed window, TimeoutError past the wait bound and
        :class:`CoalescerStoppedError` on a stopped coalescer: it never
        answers from the host in the device's place."""
        n = len(pubkeys)
        step = self.max_lanes
        groups = [(pubkeys[i : i + step], msgs[i : i + step],
                   sigs[i : i + step]) for i in range(0, n, step)]
        return self._submit_and_wait(groups or [(pubkeys, msgs, sigs)],
                                     _RESULT_TIMEOUT_S)

    # -- windows -----------------------------------------------------------

    def _device_cut(self) -> int:
        if self.min_device_lanes is not None:
            return self.min_device_lanes
        return crypto_batch.host_batch_threshold(self.device)

    @staticmethod
    def _stage(groups):
        """Flatten groups into wire lists; a lane that cannot coerce to
        bytes fails only its own ticket."""
        pubkeys: list[bytes] = []
        msgs: list[bytes] = []
        sigs: list[bytes] = []
        staged: list[tuple] = []  # (ticket, first window index)
        for ticket, (pks, ms, ss) in groups:
            try:
                lanes = [(bytes(pk), bytes(m), bytes(s))
                         for pk, m, s in zip(pks, ms, ss)]
                if len(lanes) != ticket.n:
                    raise ValueError(
                        f"lane count mismatch: {len(lanes)} != {ticket.n}")
            except Exception as e:
                ticket.fail(e)
                continue
            staged.append((ticket, len(pubkeys)))
            for pk, m, s in lanes:
                pubkeys.append(pk)
                msgs.append(m)
                sigs.append(s)
        return pubkeys, msgs, sigs, staged

    def _launch(self, groups, reason, t_pop) -> _Inflight | None:
        """Stage and dispatch one window: at its device cut, packed and
        launched asynchronously on the coalescer's stream (the in-flight
        window returns); below it, verified here by the host batch."""
        pubkeys, msgs, sigs, staged = self._stage(groups)
        if not staged:
            # every group failed staging: no window to count
            return None
        n = len(pubkeys)
        m = libmetrics.node_metrics()
        m.coalesce_window_lanes.observe(n)
        m.coalesce_flushes.labels(reason).inc()
        self.windows += 1
        t0 = time.perf_counter()
        if n < self._device_cut():
            bits = host_batch.verify_many(pubkeys, msgs, sigs)
            dt = time.perf_counter() - t0
            libmetrics.observe_verify_phase("fallback", "ed25519-coalesce",
                                            dt, n)
            crypto_batch.note_host_window(n, dt, self.device)
            self.host_lanes += n
            self.window_lanes["host"][n] += 1
            self._note_window(n, False)
            self._resolve_bits(staged, bits, reason, "host", t_pop, dt)
            return None
        buf, host_ok = ov.pack_bytes(pubkeys, msgs, sigs)
        with torch.cuda.stream(self._stream):
            hit = (ov.pubkey_cache(self.device).lookup(pubkeys)
                   if ov._cache_enabled() else None)
            arena = "hit" if hit is not None else "bypass"
            t1 = time.perf_counter()
            libmetrics.observe_verify_phase("pack", "ed25519-coalesce",
                                            t1 - t0, n, arena=arena)
            if hit is not None:
                idxs, arena_buf, arena_ok = hit
                finish = ov.verify_rsk_async(buf[32:], idxs, arena_buf,
                                             arena_ok, n, lanes=self._lanes)
            else:
                finish = ov.verify_bytes_async(buf, n, self.device,
                                               lanes=self._lanes)
        libmetrics.observe_verify_phase(
            "dispatch", "ed25519-coalesce", time.perf_counter() - t1, n,
            arena=arena)
        self.device_windows += 1
        self.device_lanes += n
        self.window_lanes["device"][n] += 1
        self._note_window(n, True)
        return _Inflight(finish, host_ok, staged, n,
                         time.perf_counter() - t0, reason, t_pop)

    def _finish(self, fl: _Inflight) -> None:
        """Read back a device window and resolve its tickets."""
        mark = self._readback_mark()
        t0 = time.perf_counter()
        valid = fl.finish() & fl.host_ok
        readback_s = time.perf_counter() - t0
        self._note_readback(mark)
        libmetrics.observe_verify_phase("readback", "ed25519-coalesce",
                                        readback_s, fl.lanes)
        crypto_batch.note_device_window(fl.lanes, fl.prep_s + readback_s,
                                        self.device)
        self._resolve_bits(fl.staged, [bool(b) for b in valid], fl.reason,
                           "device", fl.t_launch, fl.prep_s + readback_s)

    def _resolve_bits(self, staged, bits, reason, backend, t_launch,
                      exec_s) -> None:
        """Resolve a window's tickets, then charge them: each ticket's
        queue wait runs from its submit to the window's pop (``t_launch``),
        and the window's ``exec_s`` (pack+dispatch+readback on the device,
        the batch on the host) is split among its tickets by lanes. The
        whole block rides the ledger's switch (COMETBFT_TPU_LEDGER=0 costs
        one flag check), the wait histogram of the coalescer aside."""
        self._resolve(staged, bits)
        m = libmetrics.node_metrics()
        now = time.perf_counter()
        total = sum(ticket.n for ticket, _ in staged)
        plane = self.LEDGER_PLANE
        ledger_on = libdevledger.enabled()
        exec_ns = int(exec_s * 1e9)
        if ledger_on and exec_ns > 0:
            libdevledger.note_window_time(plane, exec_ns)
        device = backend == "device"
        bw = bx = 0  # consensus callers' wait and execute (the budget row)
        for ticket, _ in staged:
            m.coalesce_wait_seconds.observe(now - ticket.t_submit)
            if not ledger_on:
                continue
            wait_ns = max(0, int((t_launch - ticket.t_submit) * 1e9))
            share = exec_ns * ticket.n // total
            cid = ticket.caller
            libdevledger.note_resolve(plane, cid, ticket.n, wait_ns,
                                      share if device else 0,
                                      0 if device else share)
            m.device_queue_wait.labels(
                "verify", libdevledger.caller_name(cid)).observe(wait_ns / 1e9)
            if cid in libdevledger.BUDGET_VERIFY_CALLERS:
                bw += wait_ns
                bx += share
        if bw or bx:
            # the per-height budget's overlay row (libs/health.budget)
            libhealth.record(libhealth.EV_BUDGET, 0, plane, bw, bx)
        if libtrace.enabled():
            libtrace.event("coalesce.flush", reason=reason, backend=backend,
                           lanes=total, tickets=len(staged))


# -- process-wide routing switch ------------------------------------------
#
# A stack: the most recent routable coalescer receives routed verifies;
# pops are by identity, so out-of-order shutdowns cannot evict a live one.

_ACTIVE: list[VerifyCoalescer] = []


def push_active(co: VerifyCoalescer) -> None:
    """Install ``co`` as the process-wide routed coalescer."""
    _ACTIVE.append(co)


def pop_active(co: VerifyCoalescer) -> None:
    for i in range(len(_ACTIVE) - 1, -1, -1):
        if _ACTIVE[i] is co:
            del _ACTIVE[i]
            return


def active() -> VerifyCoalescer | None:
    """The routed coalescer, or None when verification is unrouted."""
    for co in reversed(tuple(_ACTIVE)):
        if co.routable():
            return co
    return None


def configured_mode() -> str:
    """COMETBFT_TPU_COALESCE: "auto" (the default), "on" ("1", "on",
    "true", "yes") or "off" ("0", "off", "false", "no")."""
    v = os.environ.get("COMETBFT_TPU_COALESCE", "auto").lower()
    if v in ("1", "on", "true", "yes"):
        return "on"
    if v in ("0", "off", "false", "no"):
        return "off"
    return "auto"


def node_wants_coalescer() -> bool:
    """Whether a node should start a VerifyCoalescer: forced by
    COMETBFT_TPU_COALESCE on or off, else (auto) when CUDA is there."""
    mode = configured_mode()
    if mode != "auto":
        return mode == "on"
    from ..libs.accel import accelerator_backend

    return accelerator_backend()


def eligible(pub_key) -> bool:
    """Keys the coalescer can carry (ed25519, the device wire format)."""
    return (
        getattr(pub_key, "type", None) == ED25519_KEY_TYPE
        and len(getattr(pub_key, "data", b"") or b"") == 32
    )


def verify_signature(pub_key, msg: bytes, signature: bytes) -> bool:
    """Single-signature verify, coalesced when a coalescer is routed and
    the key is eligible; otherwise ``pub_key.verify_signature``. A routed
    window that fails raises."""
    co = active()
    if co is not None and eligible(pub_key):
        return bool(co.try_verify([pub_key.data], [msg], [signature])[0])
    return pub_key.verify_signature(msg, signature)


def verify_bytes(pubkeys, msgs, sigs) -> list[bool] | None:
    """Per-lane bits of raw 32-byte ed25519 keys through the routed
    coalescer, or None when verification is unrouted (crypto/batch.py's
    small batches then run the host batch)."""
    co = active()
    if co is None:
        return None
    return co.try_verify(pubkeys, msgs, sigs)
