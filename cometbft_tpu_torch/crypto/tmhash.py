"""SHA-256 hashing helpers (reference: crypto/tmhash/hash.go:65).

``sum`` is the universal 32-byte hash; ``sum_truncated`` the 20-byte prefix
used for addresses.
"""

from __future__ import annotations

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum(bz: bytes) -> bytes:  # noqa: A001 - mirrors reference name
    return hashlib.sha256(bz).digest()


def sum_truncated(bz: bytes) -> bytes:
    return hashlib.sha256(bz).digest()[:TRUNCATED_SIZE]
