"""Timeout scheduling (reference: consensus/ticker.go:17-47).

One pending timeout at a time; scheduling a new one for a later (H,R,S)
replaces the old (timeoutRoutine's stopTimer semantics). Fired timeouts
land on ``tock_queue`` for the consensus loop.
"""

from __future__ import annotations

import queue
import threading

from ..libs.service import BaseService
from .wal import TimeoutInfo


class TimeoutTicker(BaseService):
    def __init__(self):
        super().__init__("timeout-ticker")
        self.tock_queue: queue.Queue[TimeoutInfo] = queue.Queue()
        self._tick_queue: queue.Queue[TimeoutInfo | None] = queue.Queue()
        self._thread: threading.Thread | None = None

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._timeout_routine, name="timeout-ticker", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        self._tick_queue.put(None)  # cometlint: disable=CLNT009 -- unbounded queue: put cannot block

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self._tick_queue.put(ti)  # cometlint: disable=CLNT009 -- unbounded queue: put cannot block

    def _timeout_routine(self) -> None:
        pending: TimeoutInfo | None = None
        deadline: float | None = None
        import time as _time

        while True:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - _time.monotonic())
            try:
                ti = self._tick_queue.get(timeout=timeout)
            except queue.Empty:
                # deadline reached → fire
                if pending is not None:
                    self.tock_queue.put(pending)  # cometlint: disable=CLNT009 -- unbounded queue: put cannot block
                pending, deadline = None, None
                continue
            if ti is None:
                return
            # Newer (H,R,S) replaces pending (ticker.go:95 — must be later)
            if pending is not None and (
                ti.height, ti.round, ti.step
            ) < (pending.height, pending.round, pending.step):
                continue
            pending = ti
            deadline = _time.monotonic() + ti.duration_s
