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

``device="cpu"`` runs the kernels' plain PyTorch versions through the same
windows (the tests' path); the default ``"cuda"`` raises without a GPU.
"""

from __future__ import annotations

import collections
import os
import time

import torch

from ..libs.service import ServiceError
from ..ops import cuda_verify
from ..ops import verify as ov
from . import batch as crypto_batch
from . import host_batch
from .keys import ED25519_KEY_TYPE
from .plane import WindowPlane

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


def _env_int(name: str) -> int | None:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return None


class _Inflight:
    """A device window dispatched, not yet read back."""

    __slots__ = ("finish", "host_ok", "staged", "lanes", "prep_s")

    def __init__(self, finish, host_ok, staged, lanes, prep_s):
        self.finish = finish  # the readback closure of ops/verify
        self.host_ok = host_ok
        self.staged = staged  # [(ticket, first window index)]
        self.lanes = lanes
        self.prep_s = prep_s  # pack + dispatch seconds, for the crossover


class VerifyCoalescer(WindowPlane):
    """Background verify executor coalescing single-signature callers on
    ``device`` (see the module docstring and crypto/plane.py)."""

    STOPPED_ERROR = CoalescerStoppedError

    def __init__(
        self,
        window_us: int | None = None,
        max_lanes: int | None = None,
        min_device_lanes: int | None = None,
        device="cuda",
        max_inflight: int | None = None,
    ):
        def knob(value, name, default):
            if value is not None:
                return value
            env = _env_int(name)
            return default if env is None else env

        super().__init__(
            "VerifyCoalescer", device,
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
        bits: list[bool] = []
        for ticket in self.submit_many(groups or [(pubkeys, msgs, sigs)]):
            bits.extend(ticket.result(_RESULT_TIMEOUT_S))
        return bits

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

    def _launch(self, groups) -> _Inflight | None:
        """Stage and dispatch one window: at its device cut, packed and
        launched asynchronously on the coalescer's stream (the in-flight
        window returns); below it, verified here by the host batch."""
        pubkeys, msgs, sigs, staged = self._stage(groups)
        if not staged:
            return None
        n = len(pubkeys)
        self.windows += 1
        t0 = time.perf_counter()
        if n < self._device_cut():
            bits = host_batch.verify_many(pubkeys, msgs, sigs)
            crypto_batch.note_host_window(n, time.perf_counter() - t0,
                                          self.device)
            self.host_lanes += n
            self.window_lanes["host"][n] += 1
            self._resolve(staged, bits)
            return None
        buf, host_ok = ov.pack_bytes(pubkeys, msgs, sigs)
        with torch.cuda.stream(self._stream):
            hit = (ov.pubkey_cache(self.device).lookup(pubkeys)
                   if ov._cache_enabled() else None)
            if hit is not None:
                idxs, arena, arena_ok = hit
                finish = ov.verify_rsk_async(buf[32:], idxs, arena, arena_ok,
                                             n, lanes=self._lanes)
            else:
                finish = ov.verify_bytes_async(buf, n, self.device,
                                               lanes=self._lanes)
        self.device_windows += 1
        self.device_lanes += n
        self.window_lanes["device"][n] += 1
        return _Inflight(finish, host_ok, staged, n, time.perf_counter() - t0)

    def _finish(self, fl: _Inflight) -> None:
        """Read back a device window and resolve its tickets."""
        t0 = time.perf_counter()
        valid = fl.finish() & fl.host_ok
        crypto_batch.note_device_window(
            fl.lanes, fl.prep_s + time.perf_counter() - t0, self.device)
        self._resolve(fl.staged, [bool(b) for b in valid])


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
