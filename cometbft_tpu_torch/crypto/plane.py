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
the plane and fails what a dead or wedged executor left.

A plane defines ``STOPPED_ERROR``, ``_group_size`` (a group's lanes and
the weight its deadline budget reads), ``_launch`` (stage and dispatch one
window: an in-flight handle with a ``staged`` list of (ticket, first
index) pairs, or None once it resolved the window itself) and ``_finish``
(read back and resolve a handle). It may override ``_window_budget``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

from ..libs.service import BaseService, ServiceError
from ..ops.verify import resolve_device


class Ticket:
    """One submit's pending values; settled exactly once (the first of
    resolve and fail wins)."""

    __slots__ = ("n", "weight", "t_submit", "_done", "_lock", "_values",
                 "_exc")

    def __init__(self, n: int, weight: int = 0):
        self.n = n
        self.weight = weight  # what the deadline budget reads (SHA blocks)
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
            raise TimeoutError(
                f"coalesced window not resolved within {timeout}s "
                f"({self.n} lanes)"
            )
        if self._exc is not None:
            raise self._exc
        return list(self._values)


class WindowPlane(BaseService):
    """The executor, readback drain and lifecycle of a coalescing plane
    on ``device`` (see the module docstring)."""

    STOPPED_ERROR = ServiceError
    _JOIN_TIMEOUT_S = 10.0

    def __init__(self, name: str, device, window_s: float, max_lanes: int,
                 max_inflight: int):
        super().__init__(name)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.window_s = window_s
        self.max_lanes = max(1, max_lanes)
        self.max_inflight = max(1, max_inflight)
        self._mtx = threading.Lock()  # the pending queue and counters
        self._cv = threading.Condition(self._mtx)
        self._pending: deque[tuple] = deque()  # (ticket, group)
        self._pending_lanes = 0
        self._pending_weight = 0
        self._draining = False
        self._accepting = False
        self._thread: threading.Thread | None = None
        self._staging: list[tuple] | None = None  # the window being launched
        # executor -> drain handoff
        self._rb_mtx = threading.Lock()
        self._rb_cv = threading.Condition(self._rb_mtx)
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

    def _launch(self, groups):
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
        exc = self.STOPPED_ERROR(
            f"{self._name} stopped before this window ran")
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
        for group in groups:
            t = Ticket(*self._group_size(group))
            tickets.append(t)
            if t.n == 0:
                t.resolve([])
            else:
                staged.append((t, group))
        if not staged:
            return tickets
        with self._mtx:
            if self._draining or not self._accepting:
                raise self.STOPPED_ERROR(self._name)
            for g in staged:
                self._pending.append(g)
                self._pending_lanes += g[0].n
                self._pending_weight += g[0].weight
            self.tickets += len(staged)
            self._cv.notify_all()
        return tickets

    # -- the executor --------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                groups, reason = self._collect()
                if groups:
                    self._staging = groups
                    try:
                        fl = self._launch(groups)
                    except Exception as e:  # a dispatch fault: its window fails
                        for ticket, _ in groups:
                            ticket.fail(e)
                        fl = None
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
            for ticket, _ in fl.staged:
                ticket.fail(e)

    @staticmethod
    def _resolve(staged, out) -> None:
        for ticket, lo in staged:
            ticket.resolve(out[lo : lo + ticket.n])
