"""Switch: peer/reactor hub (reference: p2p/switch.go:109-861).

Owns the transport, the reactor set, and the peer table. Routes every
inbound message to the reactor that claimed its channel; fans out
broadcasts; redials persistent peers with exponential backoff.

Port of cometbft_tpu/p2p/switch.py. One departure: an exception that
leaves a reactor's ``receive`` stops the peer, as in the reference, unless
the device path raised it (a fault marked by libs/devicefault where it
left a batch verifier or a plane: a kernel that did not build or launch, a
stopped plane, a passed deadline). That is not the peer's fault: the
switch fail-stops the node through ``on_fatal`` (without one, the process
exits), and the peer is not blamed.
"""

from __future__ import annotations

import os
import random
import threading

from ..libs import devicefault
from ..libs import sync as libsync

from ..libs.service import BaseService
from .base_reactor import Reactor
from .conn.connection import ChannelDescriptor, MConnConfig
from .peer import Peer
from .transport import MultiplexTransport, TransportError, addr_id, parse_addr

MAX_RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_DELAY = 0.5


class SwitchError(Exception):
    pass


class Switch(BaseService):
    def __init__(
        self,
        transport: MultiplexTransport,
        mconn_config: MConnConfig | None = None,
        max_inbound: int = 40,
        max_outbound: int = 10,
    ):
        super().__init__("p2p-switch")
        self.transport = transport
        self.mconn_config = mconn_config
        self.max_inbound = max_inbound
        self.max_outbound = max_outbound
        self.reactors: dict[str, Reactor] = {}
        self._channel_to_reactor: dict[int, Reactor] = {}
        self._descriptors: list[ChannelDescriptor] = []
        self._peers: dict[str, Peer] = {}
        self._peers_mtx = libsync.RLock("p2p.switch.peers")
        self._persistent_addrs: list[str] = []
        self._dialing: set[str] = set()
        self._health_origin = 0  # interned on first peer admit
        # Fail-stop hook for a device fault that left a reactor (the node
        # wires it to a full stop; None -> os._exit, as ConsensusState's)
        self.on_fatal = None

    # -- wiring ------------------------------------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self._channel_to_reactor:
                raise SwitchError(f"channel {desc.id:#x} already claimed")
            self._channel_to_reactor[desc.id] = reactor
            self._descriptors.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def channel_ids(self) -> bytes:
        return bytes(sorted(d.id for d in self._descriptors))

    @staticmethod
    def _normalize_addr(addr: str) -> str:
        """Canonical 'id@host:port' (or 'host:port') so persistence checks
        survive formatting differences like a tcp:// scheme."""
        host, port = parse_addr(addr)
        target_id = addr_id(addr)
        base = f"{host}:{port}"
        return f"{target_id}@{base}" if target_id else base

    def set_persistent_peers(self, addrs: list[str]) -> None:
        # lockfree: wiring-phase setter — the list is frozen before on_start spawns the dial/accept routines that read it
        self._persistent_addrs = [self._normalize_addr(a) for a in addrs]

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        for reactor in self.reactors.values():
            reactor.start()
        threading.Thread(
            target=self._accept_routine, name="switch-accept", daemon=True
        ).start()

    def on_stop(self) -> None:
        self.transport.close()
        with self._peers_mtx:
            peers = list(self._peers.values())
        for peer in peers:
            self.stop_and_remove_peer(peer, "switch stopping")
        for reactor in self.reactors.values():
            if reactor.is_running():
                reactor.stop()

    # -- peers -------------------------------------------------------------

    def peers(self) -> list[Peer]:
        with self._peers_mtx:
            return list(self._peers.values())

    def num_peers(self) -> tuple[int, int]:
        with self._peers_mtx:
            out = sum(1 for p in self._peers.values() if p.outbound)
            return out, len(self._peers) - out

    def get_peer(self, peer_id: str) -> Peer | None:
        with self._peers_mtx:
            return self._peers.get(peer_id)

    def _accept_routine(self) -> None:
        while not self.quit_event().is_set():
            try:
                up = self.transport.accept()
            except OSError:
                return
            except TransportError:
                continue
            _, inbound = self.num_peers()
            if inbound >= self.max_inbound:
                up.secret_conn.close()
                continue
            try:
                self._add_peer(up, persistent=False)
            except SwitchError:
                up.secret_conn.close()

    def dial_peers_async(self, addrs: list[str]) -> None:
        for addr in addrs:
            threading.Thread(
                target=self._dial_with_backoff,
                args=(addr,),
                daemon=True,
            ).start()

    def _dial_with_backoff(self, addr: str) -> None:
        addr = self._normalize_addr(addr)
        persistent = addr in self._persistent_addrs
        target_id = addr_id(addr)
        with self._peers_mtx:
            if addr in self._dialing:
                return
            self._dialing.add(addr)
        try:
            for attempt in range(MAX_RECONNECT_ATTEMPTS):
                if self.quit_event().is_set():
                    return
                if target_id and self.get_peer(target_id) is not None:
                    return
                up = None
                try:
                    up = self.transport.dial(addr)
                    self._add_peer(up, persistent=persistent, addr=addr)
                    return
                except Exception:
                    if up is not None:
                        try:
                            up.secret_conn.close()
                        except Exception:
                            pass
                    if not persistent:
                        return
                    delay = min(
                        RECONNECT_BASE_DELAY * (2**attempt), 30.0
                    ) * (0.5 + random.random())
                    if self.quit_event().wait(delay):
                        return
        finally:
            with self._peers_mtx:
                self._dialing.discard(addr)

    def _add_peer(self, up, persistent: bool, addr: str = "") -> Peer:
        # flight-ring origin for this node's recv threads: rows they
        # record (gossip-lag events) decode with our node-id prefix, so
        # in-process multi-node rings split into per-node timelines
        # (register_origin dedupes — one interning per switch lifetime)
        if not self._health_origin:
            from ..libs import health as libhealth

            # lockfree: lazy interning — register_origin dedupes, so two racing admits store the same id and a double write is idempotent
            self._health_origin = libhealth.register_origin(
                self.transport.node_info.node_id[:10]
            )
        peer = Peer(
            up.secret_conn,
            up.node_info,
            self._descriptors,
            on_receive=self._on_peer_receive,
            on_error=self._on_peer_error,
            outbound=up.outbound,
            persistent=persistent,
            socket_addr=up.socket_addr,
            mconn_config=self.mconn_config,
            # our side of the provenance-stamp negotiation + the origin
            # id stamped onto outbound messages (libs/netstats)
            our_node_info=self.transport.node_info,
            origin_id=self._health_origin,
            logger=self.logger,
        )
        with self._peers_mtx:
            # A handshake that completed as (or after) on_stop snapshotted
            # the peer table would admit a peer nobody ever stops — its
            # connection (and netstats block) would outlive the switch.
            # stop() flips is_running() BEFORE on_stop runs, so peers in
            # the table at snapshot time are exactly the peers stopped.
            if not self.is_running():
                raise SwitchError("switch is stopping")
            if peer.id in self._peers:
                raise SwitchError(f"duplicate peer {peer.id[:10]}")
            self._peers[peer.id] = peer
            libsync.lockset_note("Switch._peers")
        try:
            for reactor in self.reactors.values():
                reactor.init_peer(peer)
            peer.start()
            for reactor in self.reactors.values():
                reactor.add_peer(peer)
        except BaseException:
            with self._peers_mtx:
                self._peers.pop(peer.id, None)
            raise
        if self.logger is not None:
            self.logger.info(
                "peer connected",
                peer=peer.id[:10],
                outbound=peer.outbound,
                addr=peer.socket_addr,
            )
        return peer

    def stop_and_remove_peer(self, peer: Peer, reason) -> None:
        with self._peers_mtx:
            if self._peers.pop(peer.id, None) is None:
                return
        try:
            if peer.is_running():
                peer.stop()
        except Exception:
            pass
        if self.logger is not None:
            self.logger.info(
                "peer disconnected", peer=peer.id[:10], reason=str(reason)
            )
        for reactor in self.reactors.values():
            try:
                reactor.remove_peer(peer, reason)
            except Exception:
                pass
        # Reconnect to persistent peers (switch.go:396).
        if peer.persistent and peer.socket_addr and not self.quit_event().is_set():
            addr = f"{peer.id}@{peer.socket_addr}"
            if peer.outbound:
                self.dial_peers_async([addr])

    def _on_peer_receive(self, ch_id: int, peer: Peer, msg: bytes) -> None:
        reactor = self._channel_to_reactor.get(ch_id)
        if reactor is None:
            self.stop_and_remove_peer(
                peer, f"message on unclaimed channel {ch_id:#x}"
            )
            return
        try:
            reactor.receive(ch_id, peer, msg)
        except Exception as e:
            if devicefault.is_fault(e):
                self._fail_stop(e)
                return
            self.stop_and_remove_peer(peer, e)

    def _fail_stop(self, err: BaseException) -> None:
        """A fault of the device path reached the network layer: stop the
        node through ``on_fatal``, or end the process without one (a node
        that keeps serving on a failed card would be the silent wedge
        consensus/state's fail-stop guards against)."""
        import traceback

        traceback.print_exception(err)
        if self.on_fatal is not None:
            self.on_fatal(err)
            return
        os._exit(1)

    def _on_peer_error(self, peer: Peer, err: Exception) -> None:
        self.stop_and_remove_peer(peer, err)

    # -- broadcast (switch.go:272) -----------------------------------------

    def broadcast(self, ch_id: int, msg: bytes) -> None:
        for peer in self.peers():
            threading.Thread(
                target=peer.send, args=(ch_id, msg), daemon=True
            ).start()

    def try_broadcast(self, ch_id: int, msg: bytes) -> None:
        for peer in self.peers():
            peer.try_send(ch_id, msg)
