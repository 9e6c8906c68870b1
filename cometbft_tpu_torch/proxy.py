"""proxy.AppConns — 4 named ABCI connections (reference:
proxy/multi_app_conn.go:21-193, proxy/app_conn.go:18-58).

The node talks to its application over four logical connections —
consensus, mempool, query, snapshot — so mempool CheckTx traffic never
queues behind block execution. For a local app they share one mutex (the
reference's ``NewLocalClientCreator``); for a socket app each connection
is its own socket. A client error triggers ``on_error`` (the reference
kills the node — fail-stop, multi_app_conn.go:129).

Only the local transport is here: the socket and gRPC clients come with
the port's p2p and RPC layers, and until then asking for them raises.
"""

from __future__ import annotations

from .libs import sync as libsync
from typing import Callable

from .abci.application import Application
from .abci.client import Client, LocalClient
from .libs.service import BaseService

ClientCreator = Callable[[], Client]


def local_client_creator(app: Application) -> ClientCreator:
    """All four connections share one mutex around one in-process app."""
    mtx = libsync.RLock("proxy.mtx")
    return lambda: LocalClient(app, mtx)


def socket_client_creator(addr: str) -> ClientCreator:
    """ABCI over a socket: not ported yet, so this raises."""
    raise NotImplementedError(
        f"the socket ABCI client is not ported yet (asked for {addr!r})")


def grpc_client_creator(addr: str) -> ClientCreator:
    """ABCI over gRPC: not ported yet, so this raises."""
    raise NotImplementedError(
        f"the gRPC ABCI client is not ported yet (asked for {addr!r})")


class AppConns(BaseService):
    def __init__(
        self,
        creator: ClientCreator,
        on_error: Callable[[Exception], None] | None = None,
    ):
        super().__init__("proxy-app-conns")
        self._creator = creator
        self._on_error = on_error
        self.consensus: Client | None = None
        self.mempool: Client | None = None
        self.query: Client | None = None
        self.snapshot: Client | None = None

    def on_start(self) -> None:
        started = []
        try:
            for name in ("query", "snapshot", "mempool", "consensus"):
                client = self._creator()
                client.set_error_callback(self.kill_on_client_error)
                client.start()
                started.append(client)
                setattr(self, name, client)
        except BaseException:
            for c in started:
                try:
                    c.stop()
                except Exception:
                    pass
            raise

    def on_stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            if c is not None and c.is_running():
                try:
                    c.stop()
                except Exception:
                    pass

    def kill_on_client_error(self, err: Exception) -> None:
        if self._on_error:
            self._on_error(err)
