"""VoteSet: 2/3-majority tracking per (height, round, type).

Reference: types/vote_set.go. Key behaviors preserved:

* one "primary" vote per validator (by index); a conflicting vote for a
  different block is admitted only if some peer claimed a 2/3 majority for
  that block (set_peer_maj23), otherwise it surfaces as
  ConflictingVoteError carrying both votes (evidence input);
* per-block tallies; ``maj23`` latches the first block to cross 2/3;
* signatures are verified BEFORE admission: ``add_vote`` one vote through
  Vote.verify (which a pushed verify coalescer routes), ``add_votes_batch``
  a whole gossip chunk through one batch verifier on ``device`` (which
  routes below the host/device cut, crypto/batch.py);
* an internal reentrant mutex (vote_set.go:60 ``mtx``): admission runs on
  the consensus receive thread while gossip routines read bit arrays and
  tallies, so multi-field state never tears across readers. ``add_vote``
  holds it while it verifies, so concurrent adders of one set serialize.

``make_extended_commit`` adds each commit-flag vote's extension and its
signature to the commit (vote_set.go MakeExtendedCommit).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import batch as crypto_batch
from ..libs import sync as libsync
from ..libs.bits import BitArray
from . import canonical
from .block import (BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig,
                    ExtendedCommit, ExtendedCommitSig)
from .validator_set import ValidatorSet
from .vote import Vote, VoteError


class VoteSetError(Exception):
    pass


@dataclass
class ConflictingVoteError(VoteSetError):
    existing: Vote
    new: Vote

    def __str__(self) -> str:
        return (
            f"conflicting votes from validator "
            f"{self.new.validator_address.hex()}"
        )


class _BlockVotes:
    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
        sig_memo: dict | None = None,
        *,
        device="cuda",
    ):
        if height == 0:
            raise VoteSetError("cannot make VoteSet for height 0")
        if extensions_enabled and signed_msg_type != canonical.PRECOMMIT_TYPE:
            raise VoteSetError("extensions require precommit vote set")
        # Optional shared memo of batch-preverified signatures:
        # (pubkey bytes, sign bytes, signature) -> bool; per-vote admission
        # pops its entry and skips the signature check on a hit.
        self.sig_memo = sig_memo
        self.device = device  # where add_votes_batch's batches verify
        self._mtx = libsync.RLock("vote_set")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.votes_bit_array = BitArray(len(val_set))
        self.votes: list[Vote | None] = [None] * len(val_set)
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    # --- queries -------------------------------------------------------------

    def size(self) -> int:
        return len(self.val_set)

    def get_by_index(self, idx: int) -> Vote | None:
        with self._mtx:
            return self.votes[idx]

    def get_by_address(self, address: bytes) -> Vote | None:
        with self._mtx:
            idx, _ = self.val_set.get_by_address(address)
            return self.votes[idx] if idx >= 0 else None

    def two_thirds_majority(self) -> BlockID | None:
        with self._mtx:
            return self.maj23

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        # integer math, as the reference's int64 (vote_set.go:340)
        with self._mtx:
            return 3 * self.sum > 2 * self.val_set.total_voting_power()

    def has_all(self) -> bool:
        with self._mtx:
            return self.sum == self.val_set.total_voting_power()

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        with self._mtx:
            bv = self.votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv is not None else None

    # --- vote admission ------------------------------------------------------

    def add_vote(self, vote: Vote) -> bool:
        """Validate, verify and admit one vote (vote_set.go:157-266).

        Returns True if the vote was newly added; raises on invalid votes.
        """
        with self._mtx:
            libsync.lockset_note("VoteSet.votes")
            self._check_vote(vote)
            val = self.val_set.get_by_index(vote.validator_index)
            self._verify_vote_signature(vote, val.pub_key)
            return self._admit(vote, val)

    def add_votes_batch(
        self, votes: list[Vote]
    ) -> tuple[list[bool], list[Exception | None]]:
        """Admit many votes through one batch verification.

        Validates and screens each vote, verifies every (pubkey, sign
        bytes, signature) triple, extension signatures included when
        enabled, in one batch verifier, then admits the valid ones. Returns
        ``(added, errors)``: ``added[i]`` marks newly admitted votes and
        ``errors[i]`` carries the vote's failure (ConflictingVoteError for
        equivocation, VoteError for a bad signature or malformed vote), the
        same signals as single ``add_vote``.
        """
        with self._mtx:
            return self._add_votes_batch_locked(votes)

    def _add_votes_batch_locked(self, votes):
        n = len(votes)
        added = [False] * n
        errors: list[Exception | None] = [None] * n

        screened: list[tuple[Vote, object]] = []
        for i, vote in enumerate(votes):
            try:
                self._check_vote(vote)
            except (VoteError, VoteSetError) as e:
                errors[i] = e
                screened.append((vote, None))
                continue
            screened.append((vote, self.val_set.get_by_index(
                vote.validator_index)))

        # keyed off the set: a set whose key type has no batch backend
        # verifies vote by vote instead
        try:
            verifier = crypto_batch.create_commit_batch_verifier(
                self.val_set, device=self.device
            )
        except ValueError:
            verifier = None

        def finish(i, vote, val, ok: bool) -> None:
            """The verdict-to-admission tail of both verify paths."""
            if not ok:
                errors[i] = VoteError(
                    f"invalid signature from validator "
                    f"{vote.validator_address.hex()}"
                )
                return
            try:
                added[i] = self._admit(vote, val)
            except ConflictingVoteError as e:
                errors[i] = e

        lanes: list[int] = []
        for i, (vote, val) in enumerate(screened):
            if val is None:
                continue
            if verifier is not None:
                verifier.add(
                    val.pub_key, vote.sign_bytes(self.chain_id),
                    vote.signature,
                )
                lanes.append(i)
                if self._needs_extension(vote):
                    verifier.add(
                        val.pub_key,
                        vote.extension_sign_bytes(self.chain_id),
                        vote.extension_signature,
                    )
                    lanes.append(i)  # a second lane for the same vote
                continue
            ok = val.pub_key.verify_signature(
                vote.sign_bytes(self.chain_id), vote.signature
            )
            if ok and self._needs_extension(vote):
                ok = val.pub_key.verify_signature(
                    vote.extension_sign_bytes(self.chain_id),
                    vote.extension_signature,
                )
            finish(i, vote, val, ok)

        if lanes:
            _, bits = verifier.verify()
            vote_ok: dict[int, bool] = {}
            for lane, ok in zip(lanes, bits):
                vote_ok[lane] = vote_ok.get(lane, True) and bool(ok)
            for i, ok in vote_ok.items():
                vote, val = screened[i]
                finish(i, vote, val, ok)
        return added, errors

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """Record a peer's claim of 2/3 for a block (vote_set.go:335-378):
        later conflicting votes for that block become admissible."""
        with self._mtx:
            existing = self.peer_maj23s.get(peer_id)
            if existing is not None:
                if existing == block_id:
                    return
                raise VoteSetError(
                    f"setPeerMaj23: conflicting claims from {peer_id}"
                )
            self.peer_maj23s[peer_id] = block_id
            key = block_id.key()
            if key not in self.votes_by_block:
                self.votes_by_block[key] = _BlockVotes(True, len(self.val_set))
            else:
                self.votes_by_block[key].peer_maj23 = True

    # --- internals -----------------------------------------------------------

    def _needs_extension(self, vote: Vote) -> bool:
        return (
            self.extensions_enabled
            and vote.msg_type == canonical.PRECOMMIT_TYPE
            and not vote.block_id.is_nil()
        )

    def _check_vote(self, vote: Vote) -> None:
        vote.validate_basic()
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.msg_type != self.signed_msg_type
        ):
            raise VoteSetError(
                f"vote H/R/T {vote.height}/{vote.round}/{vote.msg_type} "
                f"does not match set "
                f"{self.height}/{self.round}/{self.signed_msg_type}"
            )
        val = self.val_set.get_by_index(vote.validator_index)
        if val is None:
            raise VoteSetError(
                f"validator index {vote.validator_index} out of range"
            )
        if val.address != vote.validator_address:
            raise VoteSetError("validator address does not match index")
        if self._needs_extension(vote):
            if not vote.extension_signature:
                raise VoteError("missing required extension signature")
        elif self.extensions_enabled is False and (
            vote.extension or vote.extension_signature
        ):
            if vote.msg_type == canonical.PRECOMMIT_TYPE:
                raise VoteError("unexpected vote extension data")
        existing = self.votes[vote.validator_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                if existing.signature != vote.signature:
                    raise VoteSetError("same block, different signature")
                return  # an exact duplicate: _admit returns False
            # conflicting: admissible only if a peer claimed maj23 for it
            bv = self.votes_by_block.get(vote.block_id.key())
            if bv is None or not bv.peer_maj23:
                raise ConflictingVoteError(existing=existing, new=vote)

    def _verify_vote_signature(self, vote: Vote, pub_key) -> None:
        if self.sig_memo is None:
            if self._needs_extension(vote):
                vote.verify_vote_and_extension(self.chain_id, pub_key)
            else:
                vote.verify(self.chain_id, pub_key)
            return
        # The memo certifies signatures only; the address binding is not
        # in the sign bytes and is enforced here as vote.verify does, so a
        # memo hit never admits an address-spoofed relay.
        if bytes(pub_key.address()) != vote.validator_address:
            raise VoteError("invalid validator address")
        ok = self.sig_memo.pop(
            (pub_key.bytes(), vote.sign_bytes(self.chain_id), vote.signature),
            None,
        )
        if ok is False:
            raise VoteError(
                f"invalid signature from validator "
                f"{vote.validator_address.hex()}"
            )
        if self._needs_extension(vote):
            ext_ok = self.sig_memo.pop(
                (
                    pub_key.bytes(),
                    vote.extension_sign_bytes(self.chain_id),
                    vote.extension_signature,
                ),
                None,
            )
            if ext_ok is False:
                raise VoteError(
                    f"invalid extension signature from validator "
                    f"{vote.validator_address.hex()}"
                )
            if ok and ext_ok:
                return
            vote.verify_vote_and_extension(self.chain_id, pub_key)
        else:
            if ok:
                return
            vote.verify(self.chain_id, pub_key)

    def _admit(self, vote: Vote, val) -> bool:
        idx = vote.validator_index
        existing = self.votes[idx]
        key = vote.block_id.key()
        if existing is not None:
            if existing.block_id == vote.block_id:
                return False  # duplicate
            # conflicting but peer-claimed: recorded in block votes only
            bv = self.votes_by_block.get(key)
            if bv is None or not bv.peer_maj23:
                raise ConflictingVoteError(existing=existing, new=vote)
            bv.add_verified_vote(vote, val.voting_power)
            self._maybe_latch_maj23(key, vote)
            return True

        self.votes[idx] = vote
        self.votes_bit_array.set_index(idx, True)
        self.sum += val.voting_power
        bv = self.votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes(False, len(self.val_set))
            self.votes_by_block[key] = bv
        bv.add_verified_vote(vote, val.voting_power)
        self._maybe_latch_maj23(key, vote)
        return True

    def _maybe_latch_maj23(self, key: bytes, vote: Vote) -> None:
        bv = self.votes_by_block[key]
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        if bv.sum >= quorum and self.maj23 is None:
            self.maj23 = vote.block_id
            # promote block votes into primary slots (vote_set.go:257-263)
            for i, v in enumerate(bv.votes):
                if v is not None and self.votes[i] is not v:
                    if self.votes[i] is None:
                        self.votes_bit_array.set_index(i, True)
                        self.sum += self.val_set.get_by_index(i).voting_power
                    self.votes[i] = v

    # --- commit construction -------------------------------------------------

    def make_commit(self) -> Commit:
        """A Commit from the 2/3 majority (vote_set.go MakeCommit)."""
        with self._mtx:
            return self._make_commit_locked()

    def _make_commit_locked(self) -> Commit:
        if self.signed_msg_type != canonical.PRECOMMIT_TYPE:
            raise VoteSetError("cannot MakeCommit from non-precommit set")
        if self.maj23 is None:
            raise VoteSetError("cannot MakeCommit: no 2/3 majority")
        sigs = []
        for vote in self.votes:
            if (
                vote is not None
                and vote.block_id == self.maj23
                and vote.block_id.is_complete()
            ):
                sigs.append(vote.commit_sig())
            elif vote is not None and vote.block_id.is_nil():
                sigs.append(vote.commit_sig())
            else:
                sigs.append(CommitSig.absent())
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.maj23,
            signatures=sigs,
        )

    def make_extended_commit(self, require_extensions: bool = False
                             ) -> ExtendedCommit:
        """The commit with its vote extensions (vote_set.go
        MakeExtendedCommit:636): only commit-flag signatures carry one
        (types/block.go EnsureExtensions)."""
        with self._mtx:
            commit = self._make_commit_locked()
            ext_sigs = []
            for i, cs in enumerate(commit.signatures):
                vote = self.votes[i]
                if vote is not None and cs.block_id_flag == BLOCK_ID_FLAG_COMMIT:
                    ext_sigs.append(ExtendedCommitSig(
                        commit_sig=cs, extension=vote.extension,
                        extension_signature=vote.extension_signature))
                else:
                    ext_sigs.append(ExtendedCommitSig(commit_sig=cs))
            ec = ExtendedCommit(
                height=commit.height,
                round=commit.round,
                block_id=commit.block_id,
                extended_signatures=ext_sigs,
            )
            ec.ensure_extensions(require_extensions)
            return ec
