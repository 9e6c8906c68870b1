"""Round → {prevotes, precommits} vote tracking for one height
(reference: consensus/types/height_vote_set.go:286).

Tracks every round's VoteSets, bounds peer-initiated round creation via
peer-claimed 2/3 majorities (one catchup round per peer), and surfaces
POL (proof-of-lock) queries. ``device`` is where each VoteSet's batches
verify (types/vote_set).
"""

from __future__ import annotations

from ..libs import sync as libsync

from ..types import canonical
from ..types.validator_set import ValidatorSet
from ..types.vote import Vote
from ..types.vote_set import VoteSet

MAX_CATCHUP_ROUNDS = 2


class HeightVoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        validators: ValidatorSet,
        extensions_enabled: bool = False,
        *,
        device="cuda",
    ):
        self.device = device
        self.chain_id = chain_id
        self.height = height
        self.val_set = validators
        self.extensions_enabled = extensions_enabled
        self._mtx = libsync.RLock("consensus.height_vote_set._mtx")
        self._round = 0
        self._round_vote_sets: dict[int, tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        # Shared across every VoteSet of this height: the consensus receive
        # loop batch-preverifies drained vote signatures into this memo so
        # per-vote admission skips the per-signature check (SURVEY §7(d)).
        self.sig_memo: dict = {}
        # uncontended here, but every post-construction write to
        # _round_vote_sets holds this lock — taking it for the round-0
        # seed keeps the inferred guard (cometlint CLNT011) exact
        with self._mtx:
            self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        prevotes = VoteSet(
            self.chain_id, self.height, round_,
            canonical.PREVOTE_TYPE, self.val_set,
            sig_memo=self.sig_memo, device=self.device,
        )
        precommits = VoteSet(
            self.chain_id, self.height, round_,
            canonical.PRECOMMIT_TYPE, self.val_set,
            extensions_enabled=self.extensions_enabled,
            sig_memo=self.sig_memo, device=self.device,
        )
        self._round_vote_sets[round_] = (prevotes, precommits)
        libsync.lockset_note("HeightVoteSet._round_vote_sets")

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist through round_+1 (height_vote_set.go:104)."""
        with self._mtx:
            new_round = self._round
            for r in range(self._round, round_ + 2):
                self._add_round(r)
            self._round = max(new_round, round_)

    def round(self) -> int:
        with self._mtx:
            return self._round

    # -- vote ingest -------------------------------------------------------

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """AddVote (height_vote_set.go:126): unknown rounds are only
        admitted for peers that claimed a 2/3 majority there (bounded)."""
        with self._mtx:
            if not canonical.is_vote_type(vote.msg_type):
                raise ValueError(f"not a vote type: {vote.msg_type}")
            vs = self._get_locked(vote.round, vote.msg_type)
            if vs is None:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if len(rounds) < MAX_CATCHUP_ROUNDS:
                    self._add_round(vote.round)
                    vs = self._get_locked(vote.round, vote.msg_type)
                    rounds.append(vote.round)
                else:
                    # Punishable spam: peer opens too many rounds.
                    raise GotVoteFromUnwantedRoundError(
                        f"peer {peer_id} round {vote.round}"
                    )
            return vs.add_vote(vote)

    # -- queries -----------------------------------------------------------

    def _get_locked(self, round_: int, msg_type: int) -> VoteSet | None:
        pair = self._round_vote_sets.get(round_)
        if pair is None:
            return None
        return pair[0] if msg_type == canonical.PREVOTE_TYPE else pair[1]

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_locked(round_, canonical.PREVOTE_TYPE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_locked(round_, canonical.PRECOMMIT_TYPE)

    def pol_info(self) -> tuple[int, object]:
        """Highest round with a prevote 2/3 majority (POLRound, POLBlockID)."""
        with self._mtx:
            for r in range(self._round, -1, -1):
                vs = self._get_locked(r, canonical.PREVOTE_TYPE)
                if vs is not None:
                    maj = vs.two_thirds_majority()
                    if maj is not None:
                        return r, maj
            return -1, None

    def set_peer_maj23(
        self, round_: int, msg_type: int, peer_id: str, block_id
    ) -> None:
        """Only existing rounds — claimed majorities must not let a peer
        allocate arbitrary rounds (height_vote_set.go SetPeerMaj23)."""
        with self._mtx:
            vs = self._get_locked(round_, msg_type)
            if vs is not None:
                vs.set_peer_maj23(peer_id, block_id)


class GotVoteFromUnwantedRoundError(Exception):
    pass
