"""L6 mempool (reference: mempool/)."""

from .cache import LRUTxCache, NopTxCache  # noqa: F401
from .clist_mempool import CListMempool, MempoolError, TxKey  # noqa: F401
