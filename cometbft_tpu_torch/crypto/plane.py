"""The window executor shared by the hash plane and the verify coalescer.

Concurrent callers submit lane groups and block on a :class:`Ticket`; an
executor thread pops windows from the pending queue, flushed by size
(``max_lanes``) or by a deadline anchored at the oldest pending ticket,
and hands each to the plane's ``_launch``. A window launched on the device
comes back as an in-flight handle that a readback drain thread finishes in
submission order, each behind its own event, while the executor packs the
next one; ``max_inflight`` bounds that pipeline. A CUDA plane launches on
a stream of its own.

No fallback: a fault at launch or at readback fails the tickets of its
window and the callers raise. Stopping drains the pending windows through
the plane and fails what a dead or wedged executor left. Each of these
faults, a stopped plane's refusal and a timed-out wait are marked as the
device path's (libs/devicefault); a lane that does not coerce to bytes
fails its own ticket unmarked, as its caller's error.

Request deadlines: a caller that wraps its work in
:func:`request_deadline` bounds every ticket wait of its thread by the
request's remaining budget (nested scopes tighten, never loosen). A
routed call whose deadline has passed raises TimeoutError before it
submits anything, and a ticket wait past it raises TimeoutError too.

Reports (libs/devledger, with the plane's ``LEDGER_PLANE`` code): every
ticket carries the caller class its submitting thread declared
(``devledger.caller_class``); the executor's busy section brackets each
launch (``exec_begin``/``exec_end``), and the helpers below note each
window and each readback's overlap with the executor. The per-ticket
split of a window's time is each plane's own (its ``_resolve_bits``).

A plane defines ``STOPPED_ERROR``, ``LEDGER_PLANE``, ``_group_size`` (a
group's lanes and the weight its deadline budget reads), ``_launch``
(stage and dispatch one window: an in-flight handle with a ``staged`` list
of (ticket, first index) pairs, or None once it resolved the window
itself) and ``_finish`` (read back and resolve a handle). It may override
``_window_budget``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import torch

from ..libs import devicefault
from ..libs import devledger as libdevledger
from ..libs import sync as libsync
from ..libs.service import BaseService, ServiceError
from ..ops.verify import resolve_device


def knob(value, env_name: str, default):
    """A constructor argument, else the integer in ``env_name``, else
    ``default``."""
    if value is not None:
        return value
    try:
        return int(os.environ.get(env_name, ""))
    except ValueError:
        return default


# -- per-request deadlines ------------------------------------------------

_DEADLINE_TLS = threading.local()


@contextlib.contextmanager
def request_deadline(deadline_monotonic: float):
    """Bound every plane wait on this thread by a monotonic deadline.
    Nested scopes tighten, never loosen: an inner deadline later than the
    enclosing one is clamped to the outer budget."""
    prev = getattr(_DEADLINE_TLS, "deadline", None)
    _DEADLINE_TLS.deadline = (
        deadline_monotonic if prev is None else min(prev, deadline_monotonic))
    try:
        yield
    finally:
        _DEADLINE_TLS.deadline = prev


def deadline_remaining() -> float | None:
    """Seconds left in this thread's request deadline (None: unbounded).
    Negative once the deadline has passed."""
    d = getattr(_DEADLINE_TLS, "deadline", None)
    if d is None:
        return None
    return d - time.monotonic()


class Ticket:
    """One submit's pending values; settled exactly once (the first of
    resolve and fail wins)."""

    __slots__ = ("n", "weight", "caller", "t_submit", "_done", "_lock",
                 "_values", "_exc")

    def __init__(self, n: int, weight: int = 0, caller: int = 0):
        self.n = n
        self.weight = weight  # what the deadline budget reads (SHA blocks)
        # the submitting thread's caller class (libs/devledger): the
        # ledger's attribution key
        self.caller = caller
        self.t_submit = time.perf_counter()
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._values: list | None = None
        self._exc: BaseException | None = None

    def resolve(self, values) -> None:
        with self._lock:
            if not self._done.is_set():
                self._values = list(values)
                self._done.set()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if not self._done.is_set():
                self._exc = exc
                self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> list:
        """Block for this submit's values; raises the window's fault, or
        TimeoutError after ``timeout`` seconds."""
        if not self._done.wait(timeout):
            raise devicefault.mark(TimeoutError(
                f"coalesced window not resolved within {timeout}s "
                f"({self.n} lanes)"
            ), "plane")
        if self._exc is not None:
            raise self._exc
        return list(self._values)


class WindowPlane(BaseService):
    """The executor, readback drain and lifecycle of a coalescing plane
    on ``device`` (see the module docstring)."""

    STOPPED_ERROR = ServiceError
    LEDGER_PLANE: int  # the plane's code in libs/devledger
    _JOIN_TIMEOUT_S = 10.0

    def __init__(self, name: str, lock_name: str, device, window_s: float,
                 max_lanes: int, max_inflight: int):
        super().__init__(name)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.window_s = window_s
        self.max_lanes = max(1, max_lanes)
        self.max_inflight = max(1, max_inflight)
        # the pending queue and counters, named as the reference names
        # the plane's locks (``lock_name``, e.g. "crypto.coalesce")
        self._mtx = libsync.Mutex(f"{lock_name}._mtx")
        self._cv = libsync.Condition(self._mtx, name=f"{lock_name}._mtx")
        self._pending: deque[tuple] = deque()  # (ticket, group)
        self._pending_lanes = 0
        self._pending_weight = 0
        self._draining = False
        self._accepting = False
        self._thread: threading.Thread | None = None
        self._staging: list[tuple] | None = None  # the window being launched
        # executor -> drain handoff
        self._rb_mtx = libsync.Mutex(f"{lock_name}._rb_mtx")
        self._rb_cv = libsync.Condition(self._rb_mtx,
                                        name=f"{lock_name}._rb_mtx")
        self._readback: deque = deque()
        self._rb_busy = 0
        self._rb_closed = False
        self._rb_alive = False
        self._rb_thread: threading.Thread | None = None
        # windows flushed, by reason and those that ran on the device;
        # tickets taken
        self.flushes = {"size": 0, "deadline": 0, "drain": 0}
        self.windows = 0
        self.device_windows = 0
        self.tickets = 0

    # -- what a plane defines ------------------------------------------------

    def _group_size(self, group) -> tuple[int, int]:
        raise NotImplementedError

    def _launch(self, groups, reason: str, t_pop: float):
        """``reason``: why the window flushed; ``t_pop``: when it left the
        queue (perf_counter), the anchor of its tickets' queue wait."""
        raise NotImplementedError

    def _finish(self, fl) -> None:
        raise NotImplementedError

    def _prepare(self) -> None:
        """Build what windows need before the plane accepts any."""

    def _window_budget(self) -> float:
        """Seconds a window may wait for more lanes after its oldest
        ticket; the caller holds the queue lock."""
        return self.window_s

    # -- lifecycle -----------------------------------------------------------

    def on_start(self) -> None:
        self._prepare()  # windows never wait on a build
        with self._mtx:
            self._draining = False
        with self._rb_mtx:
            self._rb_closed = False
            self._rb_alive = True
        self._rb_thread = threading.Thread(
            target=self._drain_run, name=f"{self._name}-readback",
            daemon=True)
        self._rb_thread.start()
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True)
        self._thread.start()
        with self._mtx:
            self._accepting = True

    def on_stop(self) -> None:
        """Drain: pending tickets go through the plane before stop
        returns; what a dead or wedged executor left is failed."""
        with self._mtx:
            self._draining = True
            self._accepting = False
            self._cv.notify_all()
        with self._rb_mtx:
            self._rb_cv.notify_all()  # an executor at the depth bound
        for t in (self._thread, self._rb_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=self._JOIN_TIMEOUT_S)
        self._fail_leftovers()

    def _fail_leftovers(self) -> None:
        with self._mtx:
            leftovers, self._pending = self._pending, deque()
            self._pending_lanes = self._pending_weight = 0
        with self._rb_mtx:
            flights, self._readback = list(self._readback), deque()
        exc = devicefault.mark(self.STOPPED_ERROR(
            f"{self._name} stopped before this window ran"), self._name)
        tickets = [t for t, _ in leftovers]
        tickets += [t for t, _ in self._staging or ()]
        tickets += [t for fl in flights for t, _ in fl.staged]
        for ticket in tickets:
            ticket.fail(exc)

    def routable(self) -> bool:
        """Accepting submits."""
        return self._accepting

    # -- submission ----------------------------------------------------------

    def submit_many(self, groups) -> list[Ticket]:
        """Submit several lane groups as one queue transaction, so a
        chunked batch packs into consecutive windows. Raises
        ``STOPPED_ERROR`` once the drain began."""
        tickets: list[Ticket] = []
        staged: list[tuple] = []
        cid = libdevledger.current_caller()
        for group in groups:
            t = Ticket(*self._group_size(group), cid)
            tickets.append(t)
            if t.n == 0:
                t.resolve([])
            else:
                staged.append((t, group))
        if not staged:
            return tickets
        with self._mtx:
            if self._draining or not self._accepting:
                raise devicefault.mark(self.STOPPED_ERROR(self._name),
                                       self._name)
            for g in staged:
                self._pending.append(g)
                self._pending_lanes += g[0].n
                self._pending_weight += g[0].weight
            self.tickets += len(staged)
            self._cv.notify_all()
        return tickets

    def _submit_and_wait(self, groups, bound_s: float) -> list:
        """Submit ``groups`` and wait for their values in order, each
        ticket's wait bounded by ``bound_s`` and by the thread's request
        deadline. Raises TimeoutError without submitting once the deadline
        has passed, and TimeoutError when a wait runs out."""
        rem = deadline_remaining()
        if rem is not None and rem <= 0:
            raise devicefault.mark(TimeoutError(
                f"{self._name}: the request deadline passed before submit"),
                self._name)
        values: list = []
        for ticket in self.submit_many(groups):
            wait_s = bound_s
            rem = deadline_remaining()
            if rem is not None and rem < wait_s:
                wait_s = max(rem, 0.0)
            values.extend(ticket.result(wait_s))
        return values

    # -- the ledger's plane-grain notes ---------------------------------------

    def _note_window(self, lanes: int, device: bool) -> None:
        """One window flushed into launch."""
        libdevledger.note_window(self.LEDGER_PLANE, lanes, device)

    def _readback_mark(self) -> tuple[int, int]:
        """Taken as a readback starts: (monotonic ns, executor-busy ns)."""
        return (time.monotonic_ns(),
                libdevledger.exec_busy_ns(self.LEDGER_PLANE))

    def _note_readback(self, mark: tuple[int, int]) -> None:
        """A readback begun at ``mark`` finished: its time, and how much of
        it the executor's busy sections overlapped."""
        libdevledger.note_readback(self.LEDGER_PLANE, *mark)

    # -- the executor --------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                groups, reason = self._collect()
                if groups:
                    self._staging = groups
                    t_pop = time.perf_counter()
                    # the busy section the ledger's overlap estimate reads:
                    # staging, pack and dispatch, or the inline host window
                    libdevledger.exec_begin(self.LEDGER_PLANE)
                    try:
                        fl = self._launch(groups, reason, t_pop)
                    except Exception as e:  # a dispatch fault: its window fails
                        devicefault.mark(e, self._name)
                        for ticket, _ in groups:
                            ticket.fail(e)
                        fl = None
                    finally:
                        libdevledger.exec_end(self.LEDGER_PLANE)
                    self._staging = None
                    if fl is not None:
                        self._hand_to_drain(fl)
                if reason == "quit":
                    return
        finally:
            self._close_readback()
            rt = self._rb_thread
            if rt is not None and rt is not threading.current_thread():
                rt.join(timeout=self._JOIN_TIMEOUT_S)
            with self._mtx:
                self._accepting = False
            self._fail_leftovers()

    def _collect(self):
        """Pop one flush window: (groups, reason), reason one of size,
        deadline, drain or quit. The deadline is anchored at the oldest
        pending ticket and its budget (``_window_budget``) is recomputed
        as lanes arrive."""
        with self._mtx:
            while not self._pending and not self._draining:
                self._cv.wait(0.2)
            if not self._pending:
                return None, "quit"
            first_t = self._pending[0][0].t_submit
            while self._pending_lanes < self.max_lanes and not self._draining:
                rem = self._window_budget() - (time.perf_counter() - first_t)
                if rem <= 0:
                    break
                self._cv.wait(rem)
            if self._draining:
                reason = "drain"
            elif self._pending_lanes >= self.max_lanes:
                reason = "size"
            else:
                reason = "deadline"
            self.flushes[reason] += 1
            groups: list[tuple] = []
            lanes = 0
            while self._pending and (
                not groups or lanes + self._pending[0][0].n <= self.max_lanes
            ):
                g = self._pending.popleft()
                groups.append(g)
                lanes += g[0].n
                self._pending_weight -= g[0].weight
            self._pending_lanes -= lanes
            return groups, reason

    # -- the readback drain --------------------------------------------------

    def _hand_to_drain(self, fl) -> None:
        with self._rb_mtx:
            handed = self._rb_alive and not self._rb_closed
            if handed:
                self._readback.append(fl)
                self._rb_cv.notify_all()
                while (self._rb_alive and not self._rb_closed
                       and not self._draining
                       and len(self._readback) + self._rb_busy
                       >= self.max_inflight):
                    self._rb_cv.wait(0.2)
        if not handed:
            self._finish_or_fail(fl)

    def _close_readback(self) -> None:
        with self._rb_mtx:
            self._rb_closed = True
            self._rb_cv.notify_all()

    def _drain_run(self) -> None:
        """Read back dispatched windows in submission order."""
        try:
            while True:
                with self._rb_mtx:
                    while not self._readback and not self._rb_closed:
                        self._rb_cv.wait(0.2)
                    if not self._readback:
                        return
                    fl = self._readback.popleft()
                    self._rb_busy += 1
                try:
                    self._finish_or_fail(fl)
                finally:
                    with self._rb_mtx:
                        self._rb_busy -= 1
                        self._rb_cv.notify_all()
        finally:
            with self._rb_mtx:
                self._rb_alive = False
                self._rb_cv.notify_all()

    def _finish_or_fail(self, fl) -> None:
        try:
            self._finish(fl)
        except Exception as e:  # a readback fault: its window fails
            devicefault.mark(e, self._name)
            for ticket, _ in fl.staged:
                ticket.fail(e)

    @staticmethod
    def _resolve(staged, out) -> None:
        for ticket, lo in staged:
            ticket.resolve(out[lo : lo + ticket.n])
