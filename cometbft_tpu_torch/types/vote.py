"""Vote and Proposal (reference: types/vote.go, types/proposal.go).

A Vote is one validator's signed prevote/precommit for a block (or nil).
Sign bytes are the canonical length-delimited protobuf of CanonicalVote
(types/vote.go:139-161); extensions sign a separate CanonicalVoteExtension
(precommits for non-nil blocks only).

:meth:`Vote.verify` and :meth:`Vote.verify_extension` check the signature
through crypto/coalesce.verify_signature: with a verify coalescer pushed,
concurrent voters share its windows (on the device at or above the cut,
on the native host batch below it); unrouted it is the key's own
``verify_signature``. Verdicts are the same either way, and a routed
window that fails raises here instead of being verified again.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import canonical
from .block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    CommitSig,
)

MAX_VOTE_EXTENSION_SIZE = 1024 * 1024  # types/params.go default cap


class VoteError(Exception):
    pass


@dataclass(slots=True)
class Vote:
    msg_type: int  # PREVOTE_TYPE | PRECOMMIT_TYPE
    height: int
    round: int
    block_id: BlockID  # nil BlockID = vote for nil
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id,
            self.msg_type,
            self.height,
            self.round,
            self.block_id,
            self.timestamp_ns,
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension
        )

    def verify(self, chain_id: str, pub_key) -> None:
        """Signature and address check (types/vote.go:210-232), the
        signature through crypto/coalesce.verify_signature, charged to the
        "consensus-vote" caller class unless an outer caller declared
        one (libs/devledger)."""
        from ..crypto import coalesce
        from ..libs import devledger

        if bytes(pub_key.address()) != self.validator_address:
            raise VoteError("invalid validator address")
        with devledger.caller_class("consensus-vote"):
            ok = coalesce.verify_signature(
                pub_key, self.sign_bytes(chain_id), self.signature)
        if not ok:
            raise VoteError("invalid signature")

    def verify_vote_and_extension(self, chain_id: str, pub_key) -> None:
        """Vote and extension signatures (types/vote.go:233-252)."""
        self.verify(chain_id, pub_key)
        if (
            self.msg_type == canonical.PRECOMMIT_TYPE
            and not self.block_id.is_nil()
        ):
            self.verify_extension(chain_id, pub_key)

    def verify_extension(self, chain_id: str, pub_key) -> None:
        """Extension signature only (types/vote.go:254-270), routed like
        :meth:`verify`."""
        from ..crypto import coalesce
        from ..libs import devledger

        if self.msg_type != canonical.PRECOMMIT_TYPE or self.block_id.is_nil():
            return
        with devledger.caller_class("consensus-vote"):
            ok = coalesce.verify_signature(
                pub_key, self.extension_sign_bytes(chain_id),
                self.extension_signature)
        if not ok:
            raise VoteError("invalid extension signature")

    def commit_sig(self) -> CommitSig:
        """Convert to a commit slot (types/vote.go CommitSig)."""
        if self.block_id.is_complete():
            flag = BLOCK_ID_FLAG_COMMIT
        elif self.block_id.is_nil():
            flag = BLOCK_ID_FLAG_NIL
        else:
            raise VoteError(f"invalid block id {self.block_id} for conversion")
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp_ns=self.timestamp_ns,
            signature=self.signature,
        )

    def validate_basic(self) -> None:
        if not canonical.is_vote_type(self.msg_type):
            raise VoteError("invalid vote type")
        if self.height < 0:
            raise VoteError("negative height")
        if self.round < 0:
            raise VoteError("negative round")
        self.block_id.validate_basic()
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise VoteError(f"block id must be nil or complete: {self.block_id}")
        if len(self.validator_address) != 20:
            raise VoteError("validator address must be 20 bytes")
        if self.validator_index < 0:
            raise VoteError("negative validator index")
        if not self.signature:
            raise VoteError("missing signature")
        if len(self.signature) > 64:
            raise VoteError("signature too long")
        if self.msg_type == canonical.PREVOTE_TYPE and self.extension:
            raise VoteError("prevotes cannot carry extensions")
        if self.is_nil() and (self.extension or self.extension_signature):
            # nil precommits must not carry extension data
            raise VoteError("nil votes cannot carry extensions")
        if len(self.extension) > MAX_VOTE_EXTENSION_SIZE:
            raise VoteError("extension too large")


@dataclass(slots=True)
class Proposal:
    """Block proposal (types/proposal.go)."""

    height: int
    round: int
    pol_round: int  # -1 if no proof-of-lock
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id,
            self.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise VoteError("negative height")
        if self.round < 0:
            raise VoteError("negative round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise VoteError("invalid pol round")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise VoteError("proposal block id must be complete")
        if not self.signature or len(self.signature) > 64:
            raise VoteError("bad proposal signature")


__all__ = [
    "Vote",
    "Proposal",
    "VoteError",
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
]
