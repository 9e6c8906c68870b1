"""RFC-6962 merkle root over byte slices, on hashlib.

Reference surface: crypto/merkle/tree.go (HashFromByteSlices). Domain
separation: leaf = SHA256(0x00 || item), inner = SHA256(0x01 || l || r);
the empty tree hashes to SHA256("").

The tree is walked level by level: adjacent nodes pair up and an odd tail
node is promoted unchanged, which yields the same root as the reference's
largest-power-of-two split recursion without recursing.
"""

from __future__ import annotations

from . import tmhash

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Root hash of the RFC-6962 tree over ``items``."""
    if not items:
        return tmhash.sum(b"")
    level = [tmhash.sum(LEAF_PREFIX + bytes(x)) for x in items]
    while len(level) > 1:
        nxt = [
            tmhash.sum(INNER_PREFIX + level[i] + level[i + 1])
            for i in range(0, len(level) - 1, 2)
        ]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]
