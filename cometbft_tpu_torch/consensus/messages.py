"""Consensus wire/internal messages (reference: consensus/msgs.go,
consensus/reactor.go message types). Used on the in-process queues, the
WAL, and (later) the p2p DataChannel/VoteChannel payloads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs.bits import BitArray
from ..types import BlockID
from ..types.part_set import Part
from ..types.vote import Proposal, Vote
from ..types import serialization as ser


@dataclass(slots=True)
class ProposalMessage:
    proposal: Proposal


@dataclass(slots=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass(slots=True)
class VoteMessage:
    vote: Vote


@dataclass(slots=True)
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1


@dataclass(slots=True)
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: object = None
    block_parts: BitArray | None = None
    is_commit: bool = False


@dataclass(slots=True)
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray | None = None


@dataclass(slots=True)
class HasVoteMessage:
    height: int
    round: int
    msg_type: int
    index: int


@dataclass(slots=True)
class VoteSetMaj23Message:
    height: int
    round: int
    msg_type: int
    block_id: BlockID = field(default_factory=BlockID)


@dataclass(slots=True)
class VoteSetBitsMessage:
    height: int
    round: int
    msg_type: int
    block_id: BlockID = field(default_factory=BlockID)
    votes: BitArray | None = None


ser.codec.register(
    ProposalMessage,
    BlockPartMessage,
    VoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalPOLMessage,
    HasVoteMessage,
    VoteSetMaj23Message,
    VoteSetBitsMessage,
)

# BitArray is a plain class; adapt it for the codec.
ser.codec.register_adapter(
    BitArray,
    "bits",
    lambda ba: {"bits": ba.size(), "elems": ba.to_bytes().hex()},
    lambda d: BitArray.from_bytes(d["bits"], bytes.fromhex(d["elems"])),
)
