"""Evidence of Byzantine behavior (reference: types/evidence.go).

* DuplicateVoteEvidence: two signed votes of one validator for the same
  height, round and type but different blocks (from VoteSet's
  ConflictingVoteError).
* LightClientAttackEvidence: a conflicting light block, the common
  height and the byzantine validators.

``evidence_list_hash`` is the merkle root of the evidence hashes that a
block's header carries.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..crypto import tmhash
from . import proto
from .vote import Vote


class EvidenceError(Exception):
    pass


class Evidence:
    def hash(self) -> bytes:
        raise NotImplementedError

    def height(self) -> int:
        raise NotImplementedError

    def time_ns(self) -> int:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError


def _vote_encode(v: Vote) -> bytes:
    """Deterministic vote encoding for evidence hashing."""
    return (
        proto.field_varint(1, v.msg_type)
        + proto.field_sfixed64(2, v.height)
        + proto.field_sfixed64(3, v.round)
        + proto.field_bytes(4, v.block_id.encode())
        + proto.field_message(5, proto.timestamp(v.timestamp_ns), always=True)
        + proto.field_bytes(6, v.validator_address)
        + proto.field_varint(7, v.validator_index, emit_zero=True)
        + proto.field_bytes(8, v.signature)
    )


@dataclass(slots=True)
class DuplicateVoteEvidence(Evidence):
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    @classmethod
    def from_conflicting_votes(
        cls, vote1: Vote, vote2: Vote, block_time_ns: int, val_set
    ) -> "DuplicateVoteEvidence":
        """types/evidence.go NewDuplicateVoteEvidence — orders votes by
        BlockID key and fills power info from the validator set."""
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise EvidenceError("validator not in set")
        a, b = sorted(
            (vote1, vote2), key=lambda v: v.block_id.key()
        )
        return cls(
            vote_a=a,
            vote_b=b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp_ns=block_time_ns,
        )

    def bytes(self) -> bytes:
        return (
            proto.field_bytes(1, _vote_encode(self.vote_a))
            + proto.field_bytes(2, _vote_encode(self.vote_b))
            + proto.field_varint(3, self.total_voting_power)
            + proto.field_varint(4, self.validator_power)
            + proto.field_message(
                5, proto.timestamp(self.timestamp_ns), always=True
            )
        )

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def height(self) -> int:
        return self.vote_a.height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise EvidenceError("missing vote")
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise EvidenceError("votes must be ordered by block id")
        va, vb = self.vote_a, self.vote_b
        if (va.height, va.round, va.msg_type) != (
            vb.height,
            vb.round,
            vb.msg_type,
        ):
            raise EvidenceError("votes are not for the same H/R/T")
        if va.validator_address != vb.validator_address:
            raise EvidenceError("votes are from different validators")
        if va.block_id == vb.block_id:
            raise EvidenceError("votes are for the same block")
        va.validate_basic()
        vb.validate_basic()


@dataclass(slots=True)
class LightClientAttackEvidence(Evidence):
    """types/evidence.go:266+ — conflicting header forged for light clients."""

    conflicting_block: object  # light block (signed header + val set)
    common_height: int
    byzantine_validators: list = dc_field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = 0

    def bytes(self) -> bytes:
        sh = self.conflicting_block.signed_header
        return (
            proto.field_bytes(1, sh.header.hash() or b"")
            + proto.field_sfixed64(2, self.common_height)
            + proto.field_varint(3, self.total_voting_power)
            + proto.field_message(
                4, proto.timestamp(self.timestamp_ns), always=True
            )
        )

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def height(self) -> int:
        return self.common_height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Whether this was a lunatic attack (invalid header fields) vs an
        equivocation/amnesia attack (valid header, double signing)."""
        sh = self.conflicting_block.signed_header
        h = sh.header
        return (
            h.validators_hash != trusted_header.validators_hash
            or h.next_validators_hash != trusted_header.next_validators_hash
            or h.consensus_hash != trusted_header.consensus_hash
            or h.app_hash != trusted_header.app_hash
            or h.last_results_hash != trusted_header.last_results_hash
        )

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise EvidenceError("conflicting block is nil")
        if self.common_height <= 0:
            raise EvidenceError("non-positive common height")
        if self.total_voting_power <= 0:
            raise EvidenceError("non-positive total voting power")


def evidence_list_hash(evidence: list[Evidence]) -> bytes:
    from ..crypto import merkle

    return merkle.hash_from_byte_slices([ev.hash() for ev in evidence])
