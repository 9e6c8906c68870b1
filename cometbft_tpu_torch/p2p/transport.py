"""TCP transport with encrypted upgrade (reference: p2p/transport.go:139).

Listens/dials raw TCP, then upgrades every connection: SecretConnection
handshake (authenticates the remote ed25519 key) → NodeInfo exchange →
validation (ID-matches-key, network/version compatibility). Returns the
material the Switch turns into a ``Peer``.
"""

from __future__ import annotations

import socket
import struct
import threading

from .conn.secret_connection import SecretConnection
from .key import NodeKey, node_id_from_pubkey
from .node_info import MAX_NODE_INFO_SIZE, NodeInfo


class TransportError(Exception):
    pass


def parse_addr(addr: str) -> tuple[str, int]:
    """'tcp://host:port' | 'host:port' | 'id@host:port' → (host, port)."""
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://") :]
    if "@" in addr:
        addr = addr.split("@", 1)[1]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def addr_id(addr: str) -> str | None:
    """The id part of 'id@host:port', if present."""
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://") :]
    if "@" in addr:
        return addr.split("@", 1)[0]
    return None


class UpgradedConn:
    def __init__(self, secret_conn, node_info, outbound, socket_addr):
        self.secret_conn = secret_conn
        self.node_info = node_info
        self.outbound = outbound
        self.socket_addr = socket_addr


class MultiplexTransport:
    def __init__(
        self,
        node_key: NodeKey,
        node_info: NodeInfo,
        handshake_timeout: float = 20.0,
        dial_timeout: float = 3.0,
    ):
        self.node_key = node_key
        self.node_info = node_info
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        self._listener: socket.socket | None = None
        self._closed = threading.Event()

    # -- listening ---------------------------------------------------------

    def listen(self, addr: str) -> None:
        host, port = parse_addr(addr)
        s = socket.socket(socket.AF_INET)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(32)
        self._listener = s

    @property
    def listen_addr(self) -> str:
        host, port = self._listener.getsockname()
        return f"tcp://{host}:{port}"

    def accept(self) -> UpgradedConn:
        """Blocks for the next inbound upgraded connection."""
        conn, addr = self._listener.accept()
        return self._upgrade(conn, outbound=False, socket_addr=f"{addr[0]}:{addr[1]}")

    # -- dialing -----------------------------------------------------------

    def dial(self, addr: str) -> UpgradedConn:
        host, port = parse_addr(addr)
        conn = socket.create_connection((host, port), timeout=self.dial_timeout)
        up = self._upgrade(conn, outbound=True, socket_addr=f"{host}:{port}")
        expect = addr_id(addr)
        if expect and up.node_info.node_id != expect:
            up.secret_conn.close()
            raise TransportError(
                f"dialed {expect} but got {up.node_info.node_id}"
            )
        return up

    # -- upgrade (transport.go upgrade) ------------------------------------

    def _upgrade(self, conn: socket.socket, outbound: bool, socket_addr: str):
        conn.settimeout(self.handshake_timeout)
        try:
            sc = SecretConnection(conn, self.node_key.priv_key)
            # NodeInfo exchange: u32 length + JSON, both directions.
            raw = self.node_info.encode()
            sc.write(struct.pack("<I", len(raw)) + raw)
            (length,) = struct.unpack("<I", sc.read_exact_msg(4))
            if length > MAX_NODE_INFO_SIZE:
                raise TransportError("oversized node info")
            peer_info = NodeInfo.decode(sc.read_exact_msg(length))
            peer_info.validate_basic()
            # The authenticated key must match the claimed ID.
            derived = node_id_from_pubkey(sc.remote_pub_key)
            if derived != peer_info.node_id:
                raise TransportError(
                    f"node id {peer_info.node_id} does not match "
                    f"authenticated key {derived}"
                )
            if peer_info.node_id == self.node_info.node_id:
                raise TransportError("rejecting self-connection")
            self.node_info.compatible_with(peer_info)
        except TransportError:
            try:
                conn.close()
            except OSError:
                pass
            raise
        except Exception as e:
            # Anything a hostile/broken peer can trigger mid-handshake
            # (bad JSON, bad hex, SecretConnectionError, EOF...) must not
            # escape as a non-TransportError — the accept loop would die.
            try:
                conn.close()
            except OSError:
                pass
            raise TransportError(f"{type(e).__name__}: {e}") from e
        conn.settimeout(None)
        return UpgradedConn(sc, peer_info, outbound, socket_addr)

    def close(self) -> None:
        self._closed.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
