"""Internal event switch (reference: libs/events/events.go:247).

The consensus reactor uses this lighter-weight bus (distinct from the
pubsub EventBus) to observe the consensus state's round transitions —
string event keys, no query language, synchronous fan-out in listener
registration order.
"""

from __future__ import annotations

from . import sync as libsync
from typing import Any, Callable

EventCallback = Callable[[Any], None]


class EventSwitch:
    def __init__(self) -> None:
        self._mtx = libsync.RLock("libs.events._mtx")
        # event -> {listener_id: callback}
        self._cells: dict[str, dict[str, EventCallback]] = {}

    def add_listener_for_event(
        self, listener_id: str, event: str, cb: EventCallback
    ) -> None:
        with self._mtx:
            self._cells.setdefault(event, {})[listener_id] = cb

    def remove_listener_for_event(self, event: str, listener_id: str) -> None:
        with self._mtx:
            cell = self._cells.get(event)
            if cell:
                cell.pop(listener_id, None)
                if not cell:
                    del self._cells[event]

    def remove_listener(self, listener_id: str) -> None:
        with self._mtx:
            for event in list(self._cells):
                self.remove_listener_for_event(event, listener_id)

    def fire_event(self, event: str, data: Any = None) -> None:
        with self._mtx:
            cbs = list(self._cells.get(event, {}).values())
        for cb in cbs:
            cb(data)
