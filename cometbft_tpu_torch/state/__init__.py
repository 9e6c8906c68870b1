"""L7 state & block execution (reference: state/)."""

from .state import State, make_genesis_state  # noqa: F401
from .store import Store  # noqa: F401
from .validation import validate_block  # noqa: F401
from .execution import BlockExecutor  # noqa: F401
