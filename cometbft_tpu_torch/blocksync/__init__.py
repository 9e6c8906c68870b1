"""Block-sync: fast catch-up by downloading committed blocks
(reference: blocksync/; port of cometbft_tpu/blocksync/)."""

from .pool import BlockPool  # noqa: F401
from .reactor import BlocksyncReactor  # noqa: F401
