"""Peer: one connected remote node (reference: p2p/peer.go).

Wraps the MConnection, carries the exchanged NodeInfo, and a small kv
store reactors use for per-peer state (p2p/peer.go Set/Get).

Provenance stamping (libs/netstats): when BOTH ends advertised the
``netstamp`` capability in their NodeInfo, every message on the
:data:`~..libs.netstats.STAMPED_CHANNELS` enum is prefixed with a fixed
23-byte origin stamp on send and stripped on receive (the stamp parks in
a thread-local for the reactor dispatch, which attributes gossip lag per
consensus phase).  The capability is negotiated at handshake and pinned
for the connection's lifetime — an unstamped peer sees byte-identical
wire traffic, so wire compat never depends on payload sniffing.
"""

from __future__ import annotations

import itertools
import time

from ..libs import netstats as libnetstats
from ..libs import sync as libsync
from ..libs.service import BaseService
from .conn.connection import MConnection
from .node_info import NodeInfo


class Peer(BaseService):
    def __init__(
        self,
        secret_conn,
        node_info: NodeInfo,
        channels,  # list[ChannelDescriptor]
        on_receive,  # f(ch_id, peer, msg_bytes)
        on_error,  # f(peer, err)
        outbound: bool,
        persistent: bool = False,
        socket_addr: str = "",
        mconn_config=None,
        our_node_info: NodeInfo | None = None,
        origin_id: int = 0,  # libs/health flight-ring origin of OUR node
        logger=None,
    ):
        super().__init__(f"peer-{node_info.node_id[:10]}", logger)
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr
        self._data: dict[str, object] = {}
        self._data_mtx = libsync.Mutex("p2p.peer._data_mtx")
        # Stamping is on exactly when both handshaken NodeInfos carried
        # the capability: the remote stamps toward us only when WE
        # advertised, so receive-side stripping under the same
        # condition is deterministic — no content sniffing.
        key = libnetstats.NODEINFO_STAMP_KEY
        self._stamp = bool(
            our_node_info is not None
            and our_node_info.other.get(key)
            and node_info.other.get(key)
        )
        self._origin8 = (
            libnetstats.origin_prefix(our_node_info.node_id)
            if our_node_info is not None
            else b"\0" * 8
        )
        self._stamp_seq = itertools.count(1)
        self.mconn = MConnection(
            secret_conn,
            channels,
            on_receive=lambda ch, msg: self._dispatch(ch, msg, on_receive),
            on_error=lambda err: on_error(self, err),
            config=mconn_config,
            peer_id=node_info.node_id,
            outbound=outbound,
            origin_id=origin_id,
            logger=logger,
        )

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def stamping(self) -> bool:
        """Whether this connection negotiated provenance stamps."""
        return self._stamp

    def _dispatch(self, ch_id: int, msg: bytes, on_receive) -> None:
        """Strip the provenance stamp (negotiated connections only) and
        park it for the reactor running on this recv thread."""
        if self._stamp and ch_id in libnetstats.STAMPED_CHANNELS:
            stamp, msg = libnetstats.split_stamp(msg)
            if stamp is not None:
                libnetstats.set_current_stamp(stamp, self.mconn.stats)
                try:
                    on_receive(ch_id, self, msg)
                finally:
                    libnetstats.clear_current_stamp()
                return
        on_receive(ch_id, self, msg)

    def _maybe_stamp(self, ch_id: int, msg: bytes) -> bytes:
        if self._stamp and ch_id in libnetstats.STAMPED_CHANNELS:
            seq = next(self._stamp_seq)
            wall = time.time_ns()
            stats = self.mconn.stats
            stats.stamp_tx_seq[0] = seq
            # the skew estimator pairs this send with the next inbound
            # stamp from the peer (NTP-style round trip)
            stats.stamp_tx_wall[0] = wall
            return libnetstats.make_stamp(self._origin8, seq, wall) + msg
        return msg

    def on_start(self) -> None:
        self.mconn.start()

    def on_stop(self) -> None:
        if self.mconn.is_running():
            self.mconn.stop()

    def send(self, ch_id: int, msg: bytes) -> bool:
        return self.mconn.send(ch_id, self._maybe_stamp(ch_id, msg))

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        return self.mconn.try_send(ch_id, self._maybe_stamp(ch_id, msg))

    # per-peer kv store used by reactors (peer.go Set/Get)
    def set(self, key: str, value) -> None:
        with self._data_mtx:
            self._data[key] = value

    def get(self, key: str):
        with self._data_mtx:
            return self._data.get(key)

    def __repr__(self) -> str:
        arrow = "out" if self.outbound else "in"
        return f"Peer<{arrow} {self.id[:10]}@{self.socket_addr}>"
