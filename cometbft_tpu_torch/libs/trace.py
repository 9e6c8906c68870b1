"""Low-overhead span/event tracer for the consensus and device hot paths.

Aggregate metrics cannot answer "where did THIS slow round spend its
time", which is why CometBFT grew ``libs/trace`` (a JSONL event tracer
wired into consensus and p2p). Here the batch-verify pipeline's phases
(pack / dispatch / readback / fallback) and the hash plane's emit
timestamped records into a bounded in-memory ring, optionally teed to a
rotating JSONL file (``libs/autofile.Group``).

Design constraints (in priority order):

* **Zero cost when off.** ``COMETBFT_TPU_TRACE`` unset means every
  entry point is one module-flag check and an immediate return: no
  allocation retained, no lock touched, no clock read.  Hot-path call
  sites additionally guard with :func:`enabled` before building their
  field dicts so the disabled path does not even allocate kwargs.
* **Never block an engine thread.** Record emission appends to a
  ``collections.deque`` (GIL-atomic, lock-free); the file sink has a
  dedicated writer thread draining a second deque, so no engine mutex
  ever reaches file I/O through the tracer.  The single lock here
  (``_mtx``) only serializes sink start/stop and is never held across
  blocking calls.

Record schema (one JSON object per line in the file sink, same dicts
from :func:`ring_dump`)::

    {"ts": <wall-clock ns>, "kind": "event"|"span", "name": str,
     "thread": str, ...}
    span records add:   "span": id, "parent": id, "dur_ns": int
    event records add:  "span": id of the enclosing with-span (if any)
                        plus free-form fields ("dur_ns", "backend",
                        "lanes", "height", ...)

Knobs, read at import as the JAX package reads them:
``COMETBFT_TPU_TRACE`` (1/on/true/yes enables), ``COMETBFT_TPU_TRACE_FILE``
(JSONL sink path), ``COMETBFT_TPU_TRACE_RING`` (ring capacity).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque

from . import autofile
from . import sync as libsync

_ENV_TRACE = "COMETBFT_TPU_TRACE"
_ENV_TRACE_FILE = "COMETBFT_TPU_TRACE_FILE"
_ENV_TRACE_RING = "COMETBFT_TPU_TRACE_RING"

DEFAULT_RING_SIZE = 8192

_ON_VALUES = ("1", "on", "true", "yes")


def _ring_size_from_env() -> int:
    raw = os.environ.get(_ENV_TRACE_RING, "")
    try:
        n = int(raw) if raw else DEFAULT_RING_SIZE
    except ValueError:
        n = DEFAULT_RING_SIZE
    return max(16, n)


_enabled: bool = os.environ.get(_ENV_TRACE, "").lower() in _ON_VALUES
_ring: deque = deque(maxlen=_ring_size_from_env())
_ids = itertools.count(1)  # span ids; count.__next__ is GIL-atomic
_tls = threading.local()  # .spans: stack of with-entered Span objects
_mtx = libsync.Mutex("libs.trace._mtx")  # sink start/stop only
_sink: "_FileSink | None" = None


def enabled() -> bool:
    """The one check hot paths make before building trace fields."""
    return _enabled


def enable(ring: int | None = None) -> None:
    """Turn tracing on (tests, /debug/trace/start). ``ring`` resizes the
    buffer, preserving the newest records."""
    global _enabled, _ring
    if ring is not None and ring != _ring.maxlen:
        _ring = deque(_ring, maxlen=max(16, ring))
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all buffered records (tests, bench bursts)."""
    _ring.clear()


def ring_dump() -> list[dict]:
    """Snapshot of the ring buffer, oldest first.

    Emitters append concurrently (lock-free by design); a full ring
    mutates on every append, so iteration can observe a mutation and
    raise — retry until a consistent snapshot lands rather than 500ing
    the /debug/trace scrape exactly when the node is busy.
    """
    while True:
        try:
            return list(_ring)
        except RuntimeError:  # deque mutated during iteration
            continue


def status() -> dict:
    s = _sink
    return {
        "enabled": _enabled,
        "ring_capacity": _ring.maxlen,
        "ring_len": len(_ring),
        "sink": s.path if s is not None else None,
    }


# ------------------------------------------------------------- emission


def _emit(
    kind: str,
    name: str,
    fields: dict | None,
    span_id: int = 0,
    parent_id: int = 0,
    dur_ns: int | None = None,
) -> None:
    rec: dict = {
        "ts": time.time_ns(),
        "kind": kind,
        "name": name,
        "thread": threading.current_thread().name,
    }
    if span_id:
        rec["span"] = span_id
    if parent_id:
        rec["parent"] = parent_id
    if dur_ns is not None:
        rec["dur_ns"] = dur_ns
    if fields:
        rec.update(fields)
    _ring.append(rec)
    if _sink_from_env:
        _autostart_sink_from_env()
    s = _sink
    if s is not None:
        s.put(rec)


def _span_stack() -> list:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


def event(name: str, **fields) -> None:
    """Record one point event. Attributed to the innermost with-entered
    span on this thread, if any."""
    if not _enabled:
        return
    stack = getattr(_tls, "spans", None)
    _emit("event", name, fields, span_id=stack[-1].id if stack else 0)


class Span:
    """A timed interval.  Two usage modes:

    * ``with span("name", k=v): ...`` — nests on the per-thread stack,
      so events inside attribute to it automatically;
    * ``sp = begin("name", parent=outer); ...; sp.end()`` — manual
      lifetime for state-machine phases (consensus height/round/step)
      that do not nest lexically.  Manual spans never touch the thread
      stack, so they are safe to end from a different callback.

    One record is emitted at ``end()`` carrying the measured
    ``dur_ns``; a span never ends twice.
    """

    __slots__ = ("name", "id", "parent", "fields", "_t0", "_ended")

    def __init__(self, name: str, parent_id: int, fields: dict | None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent_id
        self.fields = fields
        self._t0 = time.monotonic_ns()
        self._ended = False

    def event(self, name: str, **fields) -> None:
        if not _enabled:
            return
        _emit("event", name, fields, span_id=self.id)

    def end(self, **fields) -> None:
        if self._ended:
            return
        self._ended = True
        if not _enabled:
            # tracing was turned off mid-span: drop the record — once
            # disabled, nothing reaches the ring or sink
            return
        merged = self.fields
        if fields:
            merged = dict(merged or ())
            merged.update(fields)
        _emit(
            "span",
            self.name,
            merged,
            span_id=self.id,
            parent_id=self.parent,
            dur_ns=time.monotonic_ns() - self._t0,
        )

    def __enter__(self) -> "Span":
        _span_stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        stack = _span_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self.end()


class _NopSpan:
    """Shared do-nothing span: the disabled path allocates nothing."""

    __slots__ = ()
    id = 0

    def event(self, name: str, **fields) -> None:
        pass

    def end(self, **fields) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOP_SPAN = _NopSpan()


def span(name: str, **fields):
    """A span for ``with`` use; parent = innermost entered span."""
    if not _enabled:
        return NOP_SPAN
    stack = getattr(_tls, "spans", None)
    return Span(name, stack[-1].id if stack else 0, fields or None)


def begin(name: str, parent: "Span | None" = None, **fields):
    """Start a manually-ended span (see :class:`Span`)."""
    if not _enabled:
        return NOP_SPAN
    parent_id = parent.id if parent is not None else 0
    return Span(name, parent_id, fields or None)


# ------------------------------------------------------------ file sink


class _FileSink:
    """JSONL writer on a rotating autofile Group.

    Emitters append records to a bounded deque (lossy under extreme
    backlog — tracing must shed load, never apply backpressure); the
    dedicated writer thread drains it and owns all file I/O, so no
    engine lock is ever held across a write or rotation.
    """

    BUFFER = 1 << 16

    def __init__(self, path: str):
        self.path = path
        self.group = autofile.Group(path)
        self._buf: deque = deque(maxlen=self.BUFFER)
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="trace-sink", daemon=True
        )
        self._thread.start()

    def put(self, rec: dict) -> None:
        self._buf.append(rec)
        self._wake.set()

    def _drain(self) -> None:
        lines = []
        while True:
            try:
                lines.append(self._buf.popleft())
            except IndexError:
                break
        if lines:
            data = "".join(
                json.dumps(rec, default=str) + "\n" for rec in lines
            ).encode()
            self.group.write(data)
            self.group.flush()
            self.group.check_head_size_limit()

    def _run(self) -> None:
        while True:
            self._wake.wait(0.1)
            self._wake.clear()
            try:
                self._drain()
            except Exception as e:
                # a failing sink must never take down tracing or the
                # engine: drop to ring-only AND deregister, so status()
                # stops claiming an active sink and a fresh
                # start_file_sink isn't blocked by the corpse
                sys.stderr.write(f"trace sink failed, stopping: {e!r}\n")
                _deregister_sink(self)
                return
            if self._stop and not self._buf:
                return

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2)
        if self._thread.is_alive():
            # writer wedged inside a write (hung disk): it still owns
            # the group — racing it with a caller-thread drain/close
            # would interleave records and write on a closed file.
            # Leak the handle; the daemon thread dies with the process.
            sys.stderr.write(
                f"trace sink writer stuck; abandoning {self.path}\n"
            )
            return
        try:
            self._drain()  # writer exited: final drain on this thread
            self.group.close()
        except Exception:
            sys.stderr.write(f"trace sink close failed: {self.path}\n")


def _deregister_sink(sink: "_FileSink") -> None:
    """Clear ``sink`` from the module slot if it still owns it (writer
    self-removal on a fatal I/O error)."""
    global _sink
    with _mtx:
        if _sink is sink:
            _sink = None


def start_file_sink(path: str) -> bool:
    """Tee records to a rotating JSONL file. False if a sink is already
    active (stop it first)."""
    global _sink
    new = None
    with _mtx:
        if _sink is not None:
            return False
        new = _sink = _FileSink(path)
    return new is not None


def stop_file_sink() -> bool:
    """Stop and flush the file sink. False when none was active."""
    global _sink
    with _mtx:
        s, _sink = _sink, None
    if s is None:
        return False
    s.close()  # outside the lock: close joins the writer thread
    return True


def _autostart_sink_from_env() -> None:
    """Start the sink that COMETBFT_TPU_TRACE_FILE names, at the first
    record (importing this module starts no thread)."""
    global _sink_from_env
    path, _sink_from_env = _sink_from_env, ""
    try:
        start_file_sink(path)
    except OSError as e:
        sys.stderr.write(
            f"trace: cannot open {_ENV_TRACE_FILE}={path!r}: {e!r}\n"
        )


# the sink COMETBFT_TPU_TRACE_FILE names, started at the first record
_sink_from_env: str = os.environ.get(_ENV_TRACE_FILE, "") if _enabled else ""
