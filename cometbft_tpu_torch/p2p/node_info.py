"""Node identity/compatibility exchange (reference: p2p/node_info.go).

Exchanged right after the SecretConnection upgrade; peers are rejected on
network mismatch, protocol incompatibility, or no common channels.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

P2P_PROTOCOL_VERSION = 8
BLOCK_PROTOCOL_VERSION = 11
MAX_NODE_INFO_SIZE = 10240


class NodeInfoError(Exception):
    pass


@dataclass(slots=True)
class NodeInfo:
    node_id: str
    listen_addr: str
    network: str  # chain id
    version: str = "cometbft-tpu/0.1.0"
    channels: bytes = b""
    moniker: str = "anonymous"
    p2p_version: int = P2P_PROTOCOL_VERSION
    block_version: int = BLOCK_PROTOCOL_VERSION
    other: dict = field(default_factory=dict)

    def validate_basic(self) -> None:
        if not self.node_id:
            raise NodeInfoError("empty node id")
        if len(self.channels) > 16:
            raise NodeInfoError("too many channels")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go CompatibleWith."""
        if self.block_version != other.block_version:
            raise NodeInfoError(
                f"block version mismatch: {self.block_version} vs "
                f"{other.block_version}"
            )
        if self.network != other.network:
            raise NodeInfoError(
                f"network mismatch: {self.network!r} vs {other.network!r}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise NodeInfoError("no common channels")

    def encode(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "listen_addr": self.listen_addr,
                "network": self.network,
                "version": self.version,
                "channels": self.channels.hex(),
                "moniker": self.moniker,
                "p2p_version": self.p2p_version,
                "block_version": self.block_version,
                "other": self.other,
            },
            separators=(",", ":"),
        ).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "NodeInfo":
        if len(raw) > MAX_NODE_INFO_SIZE:
            raise NodeInfoError("node info too large")
        d = json.loads(raw)
        return cls(
            node_id=d["node_id"],
            listen_addr=d["listen_addr"],
            network=d["network"],
            version=d.get("version", ""),
            channels=bytes.fromhex(d.get("channels", "")),
            moniker=d.get("moniker", ""),
            p2p_version=int(d.get("p2p_version", 0)),
            block_version=int(d.get("block_version", 0)),
            other=d.get("other", {}),
        )
