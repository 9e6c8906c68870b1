"""Deadlock-detecting mutex tier (reference: libs/sync/deadlock.go, the
``deadlock`` build tag that swaps every mutex for go-deadlock).

Port of cometbft_tpu/libs/sync.py. ``Mutex()`` / ``RLock()`` return
plain ``threading`` primitives when every tier below is off and the
profiler's kill switch is set; otherwise:

* **Deadlock tier** (``COMETBFT_TPU_DEADLOCK=1`` or :func:`enable`):
  instrumented locks that report an acquisition waiting longer than
  ``DEADLOCK_TIMEOUT`` seconds (dumping every thread's stack and the
  holder's acquisition stack to stderr) and raise ``DeadlockError`` on a
  same-thread re-acquire of a non-reentrant Mutex.

* **Lock-order sanitizer** (``COMETBFT_TPU_LOCK_ORDER=record|enforce``):
  every instrumented acquisition keeps a per-thread stack of held lock
  *names* and derives acquisition-order edges (innermost held name ->
  newly acquired name). ``record`` accumulates the observed edges
  (:func:`observed_lock_order`); ``enforce`` raises
  :class:`LockOrderError` the moment a thread takes an edge absent from
  the static lock-order graph (``devtools/lint/graph/lockorder.json``,
  the reference's file copied into the package as data). Same-name
  edges are skipped: names label roles, so such an edge is a reentrant
  RLock or an instance hop that neither side can order.

* **Lockset sanitizer** (``COMETBFT_TPU_LOCKSET=record|enforce``):
  shared classes carry :func:`lockset_note` calls at a few accessor
  seams; each samples ``(Class.field, held-lock names)``. ``record``
  accumulates the samples (:func:`observed_locksets`); ``enforce``
  raises :class:`LocksetError` when the field's guard in
  ``fieldguards.json`` is not fully held.

* **Contention profiler** (``COMETBFT_TPU_LOCKPROF``, libs/lockprof):
  when no diagnostic tier is on, the factories hand out ``_ProfiledMutex``
  / ``_ProfiledRLock``, thin ``__slots__`` wrappers that account every
  named lock's acquires, contended acquires, wait and hold time into
  lockprof's preallocated per-slot columns. Disabled, one flag check
  stands between the caller and the raw primitive; enabled, an
  uncontended acquire takes a non-blocking probe and only a blocked one
  pays the timed path. Profiled locks implement the stdlib save/restore
  protocol, so :func:`Condition` keeps the wrapper and waiter
  re-acquires stay in the ledger. ``COMETBFT_TPU_LOCKPROF=0`` is the
  kill switch back to raw primitives.

Every mode is read at lock *construction*: flip it (env var or the
``set_*_mode`` setters) before building the objects under test. Both the
sanitizer and the profiled tiers publish each thread's blocked-on lock
and wait start into :func:`held_locks_snapshot`.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import faulthandler

from . import lockprof as _lockprof

DEADLOCK_TIMEOUT = float(os.environ.get("COMETBFT_TPU_DEADLOCK_TIMEOUT", "30"))

_enabled = os.environ.get("COMETBFT_TPU_DEADLOCK") == "1"


def enable(timeout: float | None = None) -> None:
    global _enabled, DEADLOCK_TIMEOUT
    _enabled = True
    if timeout is not None:
        DEADLOCK_TIMEOUT = timeout


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


class DeadlockError(RuntimeError):
    pass


class LockOrderError(RuntimeError):
    """An acquisition-order edge not present in the static lock-order
    graph was taken under ``COMETBFT_TPU_LOCK_ORDER=enforce``."""


class LocksetError(RuntimeError):
    """A guarded field was accessed without its statically inferred
    guard fully held, under ``COMETBFT_TPU_LOCKSET=enforce``."""


# -------------------------------------------------------- lock ordering

_LOCK_ORDER_MODES = ("off", "record", "enforce")
_order_mode = os.environ.get("COMETBFT_TPU_LOCK_ORDER", "off")
if _order_mode not in _LOCK_ORDER_MODES:
    _order_mode = "off"
_order_graph_path = os.environ.get("COMETBFT_TPU_LOCK_ORDER_GRAPH") or None

_tls = threading.local()  # .held: list[str] of instrumented-lock names
# every thread's held stack, keyed by thread id (the SAME list objects
# the TLS slots hold, registered at first use) — lets the health layer's
# black-box bundle snapshot which locks every thread held at a watchdog
# trip without reaching into foreign TLS
_all_held: dict[int, list] = {}
# every thread's blocked-on cell ``[lock name | None, wait-start ns]``
# (the SAME list objects the TLS slots hold, registered at first use —
# in-place stores keep the record path retention-free): set by a
# contended acquire in the sanitizer AND profiled tiers, cleared when
# the wait resolves, so snapshots can say who is parked on what
_all_blocked: dict[int, list] = {}
# observed (from, to) -> first witness "file:line" of the inner acquire
_observed: dict[tuple[str, str], str] = {}
_observed_mtx = threading.Lock()  # tier-internal meta-lock, never exposed
_allowed_edges: frozenset[tuple[str, str]] | None = None


def set_lock_order_mode(mode: str, graph_path: str | None = None) -> None:
    """Programmatic analog of ``COMETBFT_TPU_LOCK_ORDER`` (tests).
    Only affects locks constructed AFTER the call."""
    global _order_mode, _order_graph_path, _allowed_edges
    if mode not in _LOCK_ORDER_MODES:
        raise ValueError(f"lock-order mode must be one of {_LOCK_ORDER_MODES}")
    _order_mode = mode
    if graph_path is not None:
        _order_graph_path = graph_path
        _allowed_edges = None


def lock_order_mode() -> str:
    return _order_mode


def observed_lock_order() -> dict[tuple[str, str], str]:
    """Snapshot of recorded (outer_name, inner_name) -> witness edges."""
    with _observed_mtx:
        return dict(_observed)


def reset_lock_order() -> None:
    with _observed_mtx:
        _observed.clear()


def _static_graph_path() -> str:
    if _order_graph_path:
        return _order_graph_path
    # the reference's artifact, copied into the package as data
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "devtools", "lint", "graph", "lockorder.json",
    )


def _load_allowed_edges() -> frozenset[tuple[str, str]]:
    global _allowed_edges
    if _allowed_edges is None:
        import json

        with open(_static_graph_path(), encoding="utf-8") as f:
            data = json.load(f)
        _allowed_edges = frozenset(
            (e["from"], e["to"]) for e in data.get("edges", [])
        )
    return _allowed_edges


# ------------------------------------------------------------- locksets

_LOCKSET_MODES = ("off", "record", "enforce")
_lockset_mode = os.environ.get("COMETBFT_TPU_LOCKSET", "off")
if _lockset_mode not in _LOCKSET_MODES:
    _lockset_mode = "off"
_lockset_fields_path = os.environ.get("COMETBFT_TPU_LOCKSET_FIELDS") or None

# observed ("Class.field", frozenset(held names)) -> first witness
# "file:line" of the seam
_lockset_observed: dict[tuple[str, frozenset], str] = {}
# (guard frozenset, lockfree) per "Class.field", lazy-loaded from the
# fieldguards artifact
_field_guards: dict[str, tuple[frozenset, bool]] | None = None


def set_lockset_mode(mode: str, fields_path: str | None = None) -> None:
    """Programmatic analog of ``COMETBFT_TPU_LOCKSET`` (tests).  Only
    affects locks constructed AFTER the call — seams themselves read
    the mode live, but the held stacks they sample are only maintained
    by instrumented locks."""
    global _lockset_mode, _lockset_fields_path, _field_guards
    if mode not in _LOCKSET_MODES:
        raise ValueError(f"lockset mode must be one of {_LOCKSET_MODES}")
    _lockset_mode = mode
    if fields_path is not None:
        _lockset_fields_path = fields_path
        _field_guards = None


def lockset_mode() -> str:
    return _lockset_mode


def observed_locksets() -> dict[tuple[str, frozenset], str]:
    """Snapshot of recorded (field, held-names) -> witness samples."""
    with _observed_mtx:
        return dict(_lockset_observed)


def reset_locksets() -> None:
    with _observed_mtx:
        _lockset_observed.clear()


def _fieldguards_path() -> str:
    if _lockset_fields_path:
        return _lockset_fields_path
    # the reference's artifact, copied into the package as data
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "devtools", "lint", "graph", "fieldguards.json",
    )


def _load_field_guards() -> dict[str, tuple[frozenset, bool]]:
    global _field_guards
    if _field_guards is None:
        import json

        with open(_fieldguards_path(), encoding="utf-8") as f:
            data = json.load(f)
        _field_guards = {
            f"{e['class']}.{e['field']}": (
                frozenset(e.get("guard", ())),
                bool(e.get("lockfree")),
            )
            for e in data.get("fields", [])
        }
    return _field_guards


def lockset_note(field: str) -> None:
    """Accessor seam for the lockset sanitizer: sample (``field``, the
    calling thread's held instrumented-lock names).  Free when the
    sanitizer is off.  Callers place this INSIDE the critical section
    that the static guard of ``Class.field`` names, so record mode
    reproduces the static facts and enforce mode fails the moment a
    refactor drops a guard acquisition."""
    if _lockset_mode == "off":
        return
    held = frozenset(_held_stack())
    if _lockset_mode == "enforce":
        info = _load_field_guards().get(field)
        if info is None:
            raise LocksetError(
                f"lockset seam for unknown field {field!r}: it is not in "
                f"{_fieldguards_path()}"
            )
        guard, lockfree = info
        if not lockfree and not guard <= held:
            raise LocksetError(
                f"field {field!r} accessed with held locks "
                f"{sorted(held)!r} but its static guard is "
                f"{sorted(guard)!r} ({_fieldguards_path()}); take the "
                f"missing lock(s)."
            )
    key = (field, held)
    with _observed_mtx:
        if key not in _lockset_observed:
            _lockset_observed[key] = _acquire_site()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
        with _observed_mtx:
            _all_held[threading.get_ident()] = stack
    return stack


def _blocked_cell() -> list:
    """This thread's preallocated blocked-on cell ``[name | None,
    wait-start ns]`` — registered once, mutated in place thereafter
    (the ``_held_stack`` pattern), so setting/clearing the blocked-on
    marker on a contended acquire retains nothing."""
    cell = getattr(_tls, "blocked", None)
    if cell is None:
        cell = _tls.blocked = [None, 0]
        with _observed_mtx:
            _all_blocked[threading.get_ident()] = cell
    return cell


def held_locks_snapshot() -> dict[int, dict]:
    """Per-thread lock forensics (the health layer's ``locks.json``
    bundle surface and the thread-dump annotations): ``held`` — the
    thread's held instrumented-lock names, populated only while a
    sanitizer tier runs (``COMETBFT_TPU_LOCK_ORDER`` /
    ``COMETBFT_TPU_LOCKSET``; plain production locks keep no held
    stacks) — plus ``blocked_on`` / ``blocked_since_ns`` — the lock the
    thread is parked on right now and the ``monotonic_ns`` its wait
    began, maintained by BOTH the sanitizer and the lockprof profiled
    tiers, so live lock starvation is diagnosable in production.  Dead
    threads are pruned."""
    live = set(sys._current_frames())
    with _observed_mtx:
        for reg in (_all_held, _all_blocked):
            for tid in [t for t in reg if t not in live]:
                del reg[tid]
        out: dict[int, dict] = {}
        for tid in set(_all_held) | set(_all_blocked):
            stack = _all_held.get(tid)
            cell = _all_blocked.get(tid)
            blocked = cell[0] if cell is not None else None
            if not stack and blocked is None:
                continue
            out[tid] = {
                "held": list(stack) if stack else [],
                "blocked_on": blocked,
                "blocked_since_ns": (
                    cell[1] if blocked is not None else None
                ),
            }
        return out


def _acquire_site() -> str:
    """file:line of the engine frame performing the acquire (skips the
    sync-tier frames themselves)."""
    f = sys._getframe(1)
    here = os.path.dirname(os.path.abspath(__file__))
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.join(here, "sync.py") not in fn:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _order_check(name: str) -> None:
    """Enforce-mode gate, called BEFORE the raw acquire so a forbidden
    edge fails fast instead of deadlocking on the inversion itself."""
    stack = _held_stack()
    if not stack or stack[-1] == name:
        return
    edge = (stack[-1], name)
    if edge not in _load_allowed_edges():
        raise LockOrderError(
            f"lock-order edge {edge[0]!r} -> {edge[1]!r} is absent from the "
            f"static lock-order graph ({_static_graph_path()}); held: "
            f"{stack!r}. Fix the acquisition order, or add the edge to "
            f"the graph if the path is sound."
        )


def _order_note_acquired(name: str) -> None:
    stack = _held_stack()
    if stack and stack[-1] != name:
        edge = (stack[-1], name)
        with _observed_mtx:
            if edge not in _observed:
                _observed[edge] = _acquire_site()
    stack.append(name)


def _order_note_released(name: str) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


def _dump_all_threads(out=None) -> None:
    out = out or sys.stderr
    try:
        faulthandler.dump_traceback(file=out)
    except Exception:
        for tid, frame in sys._current_frames().items():
            out.write(f"\n--- thread {tid} ---\n")
            traceback.print_stack(frame, file=out)


class _InstrumentedMutex:
    """Non-reentrant lock with waiter timeout + self-deadlock detection."""

    _reentrant = False

    def __init__(self, name: str = ""):
        self._name = name or f"mutex@{id(self):x}"
        self._lock = (
            threading.RLock() if self._reentrant else threading.Lock()
        )
        self._holder: int | None = None
        self._holder_stack: str = ""
        self._depth = 0

    # -- context manager ---------------------------------------------------

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if not self._reentrant and self._holder == me:
            raise DeadlockError(
                f"self-deadlock: thread {me} re-acquiring {self._name}\n"
                f"first acquired at:\n{self._holder_stack}"
            )
        if _order_mode == "enforce":
            _order_check(self._name)
        if not blocking:
            ok = self._lock.acquire(False)
            if ok:
                self._note_acquired(me)
            return ok
        # threading.Lock semantics: timeout < 0 means wait forever,
        # timeout == 0 is an immediate poll
        if timeout == 0:
            ok = self._lock.acquire(False)
            if ok:
                self._note_acquired(me)
            return ok
        if self._lock.acquire(False):
            self._note_acquired(me)
            return True
        budget = timeout if timeout > 0 else None
        waited = 0.0
        next_report = DEADLOCK_TIMEOUT
        step = min(DEADLOCK_TIMEOUT, 5.0)
        cell = _blocked_cell()
        cell[1] = time.monotonic_ns()
        cell[0] = self._name
        try:
            while True:
                slice_ = (
                    step if budget is None else min(step, budget - waited)
                )
                if slice_ <= 0:
                    return False  # caller's timeout wins, report or not
                if self._lock.acquire(True, slice_):
                    self._note_acquired(me)
                    return True
                waited += slice_
                if waited >= next_report:
                    holder = self._holder
                    sys.stderr.write(
                        f"POSSIBLE DEADLOCK: thread {me} waited "
                        f"{waited:.0f}s for {self._name} "
                        f"(held by thread {holder})\n"
                        f"holder acquired at:\n{self._holder_stack}\n"
                    )
                    _dump_all_threads()
                    # report-and-continue, re-reporting each further
                    # interval (go-deadlock keeps flagging a wedged lock)
                    next_report += DEADLOCK_TIMEOUT
        finally:
            cell[0] = None

    def release(self) -> None:
        me = threading.get_ident()
        if self._reentrant and self._depth > 1:
            self._depth -= 1
        else:
            self._holder = None
            self._holder_stack = ""
            self._depth = 0
            if _order_mode != "off" or _lockset_mode != "off":
                _order_note_released(self._name)
        self._lock.release()

    def locked(self) -> bool:
        if self._reentrant:
            return self._holder is not None
        return self._lock.locked()

    def _note_acquired(self, me: int) -> None:
        if self._reentrant and self._holder == me:
            self._depth += 1
            return
        self._holder = me
        self._depth = 1
        self._holder_stack = "".join(traceback.format_stack(limit=12)[:-2])
        if _order_mode != "off" or _lockset_mode != "off":
            _order_note_acquired(self._name)


class _InstrumentedRLock(_InstrumentedMutex):
    _reentrant = True


# ------------------------------------------------- contention profiling

# A Condition re-acquire below this wait is treated as uncontended:
# unlike the ordinary acquire path there is no non-blocking probe
# available inside the stdlib's _acquire_restore protocol, so a small
# floor keeps every notify->wakeup from counting as a contended acquire
_RESTORE_CONTENDED_NS = 20_000


def _profile_wait(slot: int, wait_ns: int, site_code, site_line) -> None:
    """Bank one contended acquire; past the slow threshold, emit the
    EV_LOCK wait row naming the HOLDER's acquire site (a best-effort
    racy read of the wrapper's site slots — forensics, not bookkeeping:
    the blocker is whoever held the lock while we waited)."""
    _lockprof.note_contended(slot, wait_ns)
    if wait_ns >= _lockprof._slow_ns:
        site = (
            f"{site_code.co_filename}:{site_line}" if site_code else "?"
        )
        _lockprof.note_slow(slot, _lockprof.KIND_WAIT, wait_ns, site)


def _profile_hold(slot: int, hold_ns: int, site_code, site_line) -> None:
    """Bank one completed hold; past the slow threshold, emit the
    EV_LOCK hold row naming our own acquire site."""
    if hold_ns > 0:
        _lockprof._hold_ns[slot] += hold_ns
    if hold_ns >= _lockprof._slow_ns:
        site = (
            f"{site_code.co_filename}:{site_line}" if site_code else "?"
        )
        _lockprof.note_slow(slot, _lockprof.KIND_HOLD, hold_ns, site)


class _ProfiledMutex:
    """Contention-profiled non-reentrant lock (the production tier).

    The record path is allocation- and lock-free: preallocated
    libs/lockprof columns take GIL-atomic scalar stores, the holder
    site is kept as a code-object reference plus a line int in
    ``__slots__`` (formatted to a string only on the EV_LOCK slow
    path), and the acquire timestamp lives in a slot whose int is
    simply replaced each acquire.  Disabled, a single flag check
    stands between the caller and the raw primitive.
    """

    __slots__ = (
        "_name", "_slot", "_lock", "_t_acq", "_site_code", "_site_line",
    )

    def __init__(self, name: str = ""):
        self._name = name or f"mutex@{id(self):x}"
        self._slot = _lockprof.slot_for(self._name)
        self._lock = threading.Lock()
        self._t_acq = 0
        self._site_code = None
        self._site_line = 0

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def _stamp(self) -> None:
        # the engine frame performing the acquire: skip this module's
        # own frames (acquire/__enter__) and threading.py's Condition
        # plumbing — identity-cheap co_filename membership checks
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename in _SKIP_SITE_FILES:
            f = f.f_back
        if f is not None:
            self._site_code = f.f_code
            self._site_line = f.f_lineno
        self._t_acq = time.monotonic_ns()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        lock = self._lock
        if not _lockprof._enabled:
            return lock.acquire(blocking, timeout)
        slot = self._slot
        if lock.acquire(False):  # uncontended fast path: zero wait
            _lockprof._acquires[slot] += 1
            self._stamp()
            return True
        if not blocking or timeout == 0:
            return False
        cell = _blocked_cell()
        t0 = time.monotonic_ns()
        cell[1] = t0
        cell[0] = self._name
        try:
            ok = lock.acquire(True, timeout)
        finally:
            cell[0] = None
        wait = time.monotonic_ns() - t0
        # read the holder's site BEFORE stamping our own: the blocker
        # we waited behind is the one worth naming in the ring
        _profile_wait(slot, wait, self._site_code, self._site_line)
        if ok:
            _lockprof._acquires[slot] += 1
            self._stamp()
        return ok

    def release(self) -> None:
        t0 = self._t_acq
        if t0:
            self._t_acq = 0
            if _lockprof._enabled:
                _profile_hold(
                    self._slot, time.monotonic_ns() - t0,
                    self._site_code, self._site_line,
                )
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self):
        # Condition's ownership sanity probe — bypasses the ledger (a
        # probe is not an acquire); release/acquire during wait() go
        # through the profiled methods and stay accounted
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


class _ProfiledRLock:
    """Contention-profiled reentrant lock.  ``_depth`` (owner-thread
    mutated, so race-free) marks the outermost acquire/release pair:
    hold time spans the whole reentrant session, and reentrant
    re-acquires never count as contention.  Implements the stdlib
    save/restore protocol by delegating to the inner C RLock, so a
    Condition keeps the wrapper and waiter re-acquires stay in the
    ledger."""

    __slots__ = (
        "_name", "_slot", "_lock", "_depth", "_t_acq",
        "_site_code", "_site_line",
    )

    def __init__(self, name: str = ""):
        self._name = name or f"rlock@{id(self):x}"
        self._slot = _lockprof.slot_for(self._name)
        self._lock = threading.RLock()
        self._depth = 0
        self._t_acq = 0
        self._site_code = None
        self._site_line = 0

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def _stamp(self) -> None:
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename in _SKIP_SITE_FILES:
            f = f.f_back
        if f is not None:
            self._site_code = f.f_code
            self._site_line = f.f_lineno
        self._t_acq = time.monotonic_ns()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        lock = self._lock
        if not _lockprof._enabled or lock._is_owned():
            ok = lock.acquire(blocking, timeout)
            if ok:
                self._depth += 1
            return ok
        slot = self._slot
        if lock.acquire(False):  # uncontended fast path: zero wait
            self._depth += 1
            _lockprof._acquires[slot] += 1
            self._stamp()
            return True
        if not blocking or timeout == 0:
            return False
        cell = _blocked_cell()
        t0 = time.monotonic_ns()
        cell[1] = t0
        cell[0] = self._name
        try:
            ok = lock.acquire(True, timeout)
        finally:
            cell[0] = None
        wait = time.monotonic_ns() - t0
        _profile_wait(slot, wait, self._site_code, self._site_line)
        if ok:
            self._depth += 1
            _lockprof._acquires[slot] += 1
            self._stamp()
        return ok

    def release(self) -> None:
        d = self._depth
        if d <= 1:
            self._depth = 0
            t0 = self._t_acq
            if t0:
                self._t_acq = 0
                if _lockprof._enabled:
                    _profile_hold(
                        self._slot, time.monotonic_ns() - t0,
                        self._site_code, self._site_line,
                    )
        else:
            self._depth = d - 1
        self._lock.release()

    def locked(self) -> bool:
        return self._depth > 0

    # -- stdlib Condition save/restore protocol ---------------------------

    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        d = self._depth
        self._depth = 0
        t0 = self._t_acq
        if t0:
            self._t_acq = 0
            if _lockprof._enabled:
                _profile_hold(
                    self._slot, time.monotonic_ns() - t0,
                    self._site_code, self._site_line,
                )
        return (self._lock._release_save(), d)

    def _acquire_restore(self, state):
        inner, d = state
        if not _lockprof._enabled:
            self._lock._acquire_restore(inner)
            self._depth = d
            return
        slot = self._slot
        cell = _blocked_cell()
        t0 = time.monotonic_ns()
        cell[1] = t0
        cell[0] = self._name
        try:
            self._lock._acquire_restore(inner)
        finally:
            cell[0] = None
        wait = time.monotonic_ns() - t0
        _lockprof._acquires[slot] += 1
        if wait >= _RESTORE_CONTENDED_NS:
            _profile_wait(slot, wait, self._site_code, self._site_line)
        self._depth = d
        # keep the pre-wait acquire site: attribution names the frame
        # that entered the critical section, not threading.Condition
        self._t_acq = time.monotonic_ns()


# co_filename values the acquire-site walk skips (this module's frames
# and threading.py's Condition plumbing) — identity-stable strings, so
# the frozenset membership test on the hot stamp path is one hash probe
_SKIP_SITE_FILES = frozenset({
    _ProfiledMutex._stamp.__code__.co_filename,
    threading.Condition.wait.__code__.co_filename,
})


def _profiling_constructed() -> bool:
    """Whether the factories hand out profiled locks right now: no
    diagnostic tier active (those take precedence — their wrappers
    carry the held stacks and self-deadlock checks) and the lockprof
    kill switch not set.  Read at lock CONSTRUCTION, like the
    sanitizer modes."""
    return (
        not _enabled
        and _order_mode == "off"
        and _lockset_mode == "off"
        and _lockprof._env_mode() != "off"
    )


def Mutex(name: str = ""):
    """A non-reentrant lock; instrumented when deadlock detection or a
    sanitizer (lock-order or lockset) is on, contention-profiled
    (libs/lockprof) otherwise unless ``COMETBFT_TPU_LOCKPROF=0``."""
    if _enabled or _order_mode != "off" or _lockset_mode != "off":
        return _InstrumentedMutex(name)
    if _lockprof._env_mode() != "off":
        return _ProfiledMutex(name)
    return threading.Lock()


def RLock(name: str = ""):
    """A reentrant lock; instrumented when deadlock detection or a
    sanitizer (lock-order or lockset) is on, contention-profiled
    (libs/lockprof) otherwise unless ``COMETBFT_TPU_LOCKPROF=0``."""
    if _enabled or _order_mode != "off" or _lockset_mode != "off":
        return _InstrumentedRLock(name)
    if _lockprof._env_mode() != "off":
        return _ProfiledRLock(name)
    return threading.RLock()


def Condition(lock=None, name: str = ""):
    """A condition variable routed through the sync tier.

    Conditions are not instrumented by the DIAGNOSTIC tiers: ``wait()``
    must release and re-acquire the underlying primitive with the
    stdlib's exact save/restore protocol, which the instrumented
    wrappers deliberately don't implement (their non-reentrant
    self-deadlock check would misfire inside ``Condition._is_owned``).
    When handed an instrumented Mutex/RLock the raw lock is unwrapped,
    so waiters remain visible to the deadlock tier through every
    ordinary ``acquire`` on the associated mutex; only the wait/notify
    edge itself is uninstrumented.

    The PROFILED tier does implement the protocol, so a profiled lock
    is kept as-is — and a bare ``Condition(name=...)`` gets a profiled
    RLock under the condition's registry name, putting waiter
    re-acquires in the contention ledger too.
    """
    if isinstance(lock, _InstrumentedMutex):
        lock = lock._lock
    elif lock is None and _profiling_constructed():
        lock = _ProfiledRLock(name)
    return threading.Condition(lock)
