"""Service lifecycle primitives (reference: libs/service/service.go:24,97).

Port of cometbft_tpu/libs/service.py: every long-lived component gets a
uniform start/stop/reset contract with idempotency guarantees (started
twice -> ``AlreadyStartedError``; stopped before started -> error) and a
quit event, a small thread-safe state machine. :class:`HTTPService` is
the threaded listener of the introspection servers (libs/pprof, the
Prometheus exporter in libs/devstats) on that lifecycle.
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


class HTTPService(BaseService):
    """A threaded HTTP listener with the BaseService lifecycle.

    The shared scaffolding of the introspection servers (the pprof server
    in ``libs/pprof``, the Prometheus exporter in ``libs/devstats``):
    ``tcp://host:port`` / ``:port`` address parsing, a quiet handler, the
    daemon accept loop, ``bound_port`` capture (the port a ``:0`` address
    was given), shutdown. Subclasses implement
    ``handle_get(path, query) -> (content_type, body)`` and raise
    ``KeyError`` for unknown routes (rendered as 404; any other exception
    renders as 500).
    """

    DEFAULT_HOST = "127.0.0.1"  # debug servers stay loopback by default

    def __init__(self, name: str, addr: str, logger=None):
        super().__init__(name, logger)
        if addr.startswith("tcp://"):
            addr = addr[len("tcp://"):]
        host, _, port = addr.rpartition(":")
        self.host = host or self.DEFAULT_HOST
        self.port = int(port)
        self._httpd = None

    def handle_get(self, path: str, query: dict) -> tuple[str, str]:
        raise KeyError(path)

    def on_start(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                try:
                    ctype, text = svc.handle_get(
                        parsed.path, parse_qs(parsed.query))
                except KeyError:
                    self.send_error(404)
                    return
                except Exception as e:
                    self.send_error(500, repr(e))
                    return
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.bound_port = self._httpd.server_address[1]
        threading.Thread(
            target=self._httpd.serve_forever,
            name=f"{self._name}-http",
            daemon=True,
        ).start()

    def on_stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
