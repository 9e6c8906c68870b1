"""L6 consensus engine (reference: consensus/)."""

from .round_state import RoundState, RoundStep  # noqa: F401
from .height_vote_set import HeightVoteSet  # noqa: F401
from .ticker import TimeoutInfo, TimeoutTicker  # noqa: F401
from .wal import WAL, EndHeightMessage, NopWAL  # noqa: F401
from .state import ConsensusState  # noqa: F401
