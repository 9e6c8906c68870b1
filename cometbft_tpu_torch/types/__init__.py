"""Data model: blocks, commits, validator sets, canonical sign bytes,
commit verification, genesis, params, evidence and the mock signer
(types/, proto/tendermint)."""

from .block import (  # noqa: F401
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    Block,
    BlockID,
    BlockMeta,
    Commit,
    CommitSig,
    Data,
    ExtendedCommit,
    ExtendedCommitSig,
    Header,
    NIL_BLOCK_ID,
    PartSetHeader,
    Version,
    make_block,
)
from .canonical import (  # noqa: F401
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    PROPOSAL_TYPE,
)
from .evidence import (  # noqa: F401
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
)
from .genesis import GenesisDoc, GenesisValidator  # noqa: F401
from .params import ConsensusParams  # noqa: F401
from .part_set import Part, PartSet  # noqa: F401
from .priv_validator import ErroringMockPV, MockPV, PrivValidator  # noqa: F401
from .validation import (  # noqa: F401
    Fraction,
    NotEnoughVotingPowerError,
    VerificationError,
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
from .validator_set import Validator, ValidatorSet  # noqa: F401
from .vote import Proposal, Vote, VoteError  # noqa: F401
from .vote_set import ConflictingVoteError, VoteSet  # noqa: F401
from .light_block import LightBlock, SignedHeader  # noqa: E402,F401
