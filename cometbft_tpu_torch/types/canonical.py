"""Canonical sign bytes (consensus-critical, byte-exact).

Reference: types/canonical.go, proto/tendermint/types/canonical.proto,
types/vote.go:139-161 (VoteSignBytes, VoteExtensionSignBytes) and
types/proposal.go:102-116 (ProposalSignBytes). Sign bytes are uvarint
length-delimited protobuf (protoio.MarshalDelimited).

Message types: prevote=1, precommit=2, proposal=32
(proto/tendermint/types/types.proto).
"""

from __future__ import annotations

from functools import lru_cache

from . import proto

PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def is_vote_type(msg_type: int) -> bool:
    return msg_type in (PREVOTE_TYPE, PRECOMMIT_TYPE)


def canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return proto.field_varint(1, total) + proto.field_bytes(2, hash_)


def canonical_block_id(block_id) -> bytes:
    """CanonicalBlockID body; b'' when the block id is nil (field omitted).

    The nested part-set header is gogoproto nullable=false: always emitted.
    """
    if block_id is None or block_id.is_nil():
        return b""
    psh = block_id.part_set_header
    return proto.field_bytes(1, block_id.hash) + proto.field_message(
        2, canonical_part_set_header(psh.total, psh.hash), always=True
    )


@lru_cache(maxsize=64)
def _vote_template(chain_id, msg_type, height, round_, block_id):
    """(prefix, suffix) around a CanonicalVote's timestamp field.

    One commit encodes a vote per validator that differs only in the
    timestamp, so the rest is encoded once per round context (block ids
    are frozen dataclasses, hashable by value)."""
    return (
        proto.field_varint(1, msg_type)
        + proto.field_sfixed64(2, height)
        + proto.field_sfixed64(3, round_)
        + proto.field_message(4, canonical_block_id(block_id)),
        proto.field_string(6, chain_id),
    )


def vote_sign_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    """CanonicalVote sign bytes (types/vote.go:139, canonical.proto:30-37)."""
    prefix, suffix = _vote_template(chain_id, msg_type, height, round_,
                                    block_id)
    return proto.delimited(
        prefix
        + proto.field_message(5, proto.timestamp(timestamp_ns), always=True)
        + suffix
    )


def proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    """CanonicalProposal sign bytes (types/proposal.go:110)."""
    return proto.delimited(
        proto.field_varint(1, PROPOSAL_TYPE)
        + proto.field_sfixed64(2, height)
        + proto.field_sfixed64(3, round_)
        + proto.field_varint(4, pol_round)
        + proto.field_message(5, canonical_block_id(block_id))
        + proto.field_message(6, proto.timestamp(timestamp_ns), always=True)
        + proto.field_string(7, chain_id)
    )


def vote_extension_sign_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """CanonicalVoteExtension sign bytes (canonical.proto:41-46)."""
    return proto.delimited(
        proto.field_bytes(1, extension)
        + proto.field_sfixed64(2, height)
        + proto.field_sfixed64(3, round_)
        + proto.field_string(4, chain_id)
    )
