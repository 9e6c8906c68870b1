"""Blocksync wire messages (reference: blocksync/msgs.go, channel 0x40).

Port of cometbft_tpu/blocksync/messages.py: the codec tags by class name,
so the port's messages are byte-equal to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import serialization as ser


@dataclass(slots=True)
class StatusRequestMessage:
    pass


@dataclass(slots=True)
class StatusResponseMessage:
    height: int
    base: int


@dataclass(slots=True)
class BlockRequestMessage:
    height: int


@dataclass(slots=True)
class BlockResponseMessage:
    block: object  # types.Block
    ext_commit: object | None = None


@dataclass(slots=True)
class NoBlockResponseMessage:
    height: int


ser.codec.register(
    StatusRequestMessage,
    StatusResponseMessage,
    BlockRequestMessage,
    BlockResponseMessage,
    NoBlockResponseMessage,
)
