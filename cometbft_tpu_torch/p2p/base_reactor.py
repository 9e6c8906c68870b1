"""Reactor contract (reference: p2p/base_reactor.go:15-44).

A reactor claims channel IDs on the switch and receives every inbound
message on those channels, plus peer lifecycle callbacks.
"""

from __future__ import annotations

from ..libs.service import BaseService
from .conn.connection import ChannelDescriptor  # re-export  # noqa: F401


class Reactor(BaseService):
    def __init__(self, name: str):
        super().__init__(name)
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> list[ChannelDescriptor]:
        raise NotImplementedError

    def init_peer(self, peer) -> None:
        """Called before the peer starts (may attach per-peer state)."""

    def add_peer(self, peer) -> None:
        """Called once the peer is running (start gossip routines)."""

    def remove_peer(self, peer, reason) -> None:
        """Called when the peer is stopped/evicted."""

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        raise NotImplementedError
