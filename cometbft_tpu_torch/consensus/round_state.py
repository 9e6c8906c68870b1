"""Per-height consensus round state (reference:
consensus/types/round_state.go:224).

``RoundStep`` is the 8-step enum; ``RoundState`` is ALL mutable state the
single-writer consensus loop owns for the current height.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..types.block import Block, Commit
from ..types.part_set import PartSet
from ..types.validator_set import ValidatorSet
from ..types.vote import Proposal


class RoundStep(enum.IntEnum):
    NEW_HEIGHT = 1  # wait til commit_time + timeout_commit
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8

    @property
    def short(self) -> str:
        return {
            1: "NewHeight", 2: "NewRound", 3: "Propose", 4: "Prevote",
            5: "PrevoteWait", 6: "Precommit", 7: "PrecommitWait", 8: "Commit",
        }[int(self)]


@dataclass(slots=True)
class RoundState:
    height: int = 0
    round: int = 0
    step: RoundStep = RoundStep.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0

    validators: ValidatorSet | None = None

    proposal: Proposal | None = None
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None

    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None

    # Last known block with a POL (+2/3 prevotes); gossiped for catch-up.
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None

    votes: object | None = None  # HeightVoteSet
    commit_round: int = -1
    last_commit: object | None = None  # precommit VoteSet of height-1
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def proposal_complete(self) -> bool:
        return (
            self.proposal is not None
            and self.proposal_block is not None
        )

    def step_name(self) -> str:
        return self.step.short

    def event_fields(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "step": self.step.short,
        }
