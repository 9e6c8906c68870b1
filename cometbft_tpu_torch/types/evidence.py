"""The evidence list hash (reference: types/evidence.go).

Only what a block's header needs: the merkle root of the evidence hashes.
The evidence types themselves are not ported yet.
"""

from __future__ import annotations

from ..crypto import merkle


def evidence_list_hash(evidence: list) -> bytes:
    return merkle.hash_from_byte_slices([ev.hash() for ev in evidence])
