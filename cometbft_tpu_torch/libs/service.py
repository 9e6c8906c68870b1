"""Service lifecycle primitives (reference: libs/service/service.go:24,97).

Port of cometbft_tpu/libs/service.py: every long-lived component gets a
uniform start/stop/reset contract with idempotency guarantees (started
twice -> ``AlreadyStartedError``; stopped before started -> error) and a
quit event, a small thread-safe state machine.
"""

from __future__ import annotations

import threading


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class NotStartedError(ServiceError):
    pass


class BaseService:
    """Uniform lifecycle: ``start() -> on_start()``, ``stop() -> on_stop()``.

    Subclasses override ``on_start``/``on_stop``/``on_reset``; logging is
    injected through the ``logger`` attribute.
    """

    def __init__(self, name: str | None = None, logger=None):
        self._name = name or type(self).__name__
        self._lifecycle = threading.Lock()
        self._started = False
        self._stopped = False
        self._quit = threading.Event()
        self.logger = logger

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._stopped:
                raise AlreadyStoppedError(
                    f"{self._name}: stopped services cannot be restarted; "
                    "use reset()"
                )
            if self._started:
                raise AlreadyStartedError(self._name)
            self._started = True
        try:
            self.on_start()
        except BaseException:
            with self._lifecycle:
                self._started = False
            raise

    def stop(self) -> None:
        with self._lifecycle:
            if self._stopped:
                raise AlreadyStoppedError(self._name)
            if not self._started:
                raise NotStartedError(self._name)
            self._stopped = True
        self._quit.set()
        self.on_stop()

    def reset(self) -> None:
        with self._lifecycle:
            if not self._stopped:
                raise ServiceError(f"{self._name}: cannot reset a running service")
            self._started = False
            self._stopped = False
            self._quit = threading.Event()
        self.on_reset()

    # -- queries -----------------------------------------------------------

    def is_running(self) -> bool:
        with self._lifecycle:
            return self._started and not self._stopped

    def quit_event(self) -> threading.Event:
        """The analog of the reference's ``Quit()`` channel."""
        return self._quit

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the service stops (Quit closes)."""
        return self._quit.wait(timeout)

    @property
    def name(self) -> str:
        return self._name

    def __str__(self) -> str:
        return self._name

    # -- overridables ------------------------------------------------------

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def on_reset(self) -> None:
        pass
