"""L3 block storage (reference: store/store.go)."""

from .block_store import BlockStore  # noqa: F401
