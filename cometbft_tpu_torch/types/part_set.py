"""PartSet: block bytes split into 64 KiB parts with merkle proofs.

Port of cometbft_tpu/types/part_set.py (reference: types/part_set.go).
Blocks gossip as parts so a proposal can stream from many peers at once;
each part carries an inclusion proof against the PartSetHeader hash.

``from_data`` builds the leaves and proofs through crypto/merkle, whose
levels go to the routed hash plane when they can win there; ``add_part``
verifies a part's proof, hashing its 64 KiB leaf through the plane's
cross-caller windows, so parts arriving from many peers at once share
device windows. ``add_part`` may be called from several threads: the
proof is checked outside the lock, the store inside it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..crypto import merkle
from ..libs import sync as libsync
from ..libs.bits import BitArray
from .block import BLOCK_PART_SIZE_BYTES, PartSetHeader


class PartSetError(Exception):
    pass


@dataclass(slots=True)
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise PartSetError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise PartSetError("part too big")


class PartSet:
    @classmethod
    def from_data(cls, data: bytes,
                  part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split ``data`` into parts and proofs (part_set.go
        NewPartSetFromData)."""
        chunks = [
            data[i : i + part_size] for i in range(0, len(data), part_size)
        ] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, chunk in enumerate(chunks):
            # proofs just computed here need no re-verification; gossip
            # ingress takes the verifying add_part
            ps._add_trusted_part(Part(index=i, bytes_=chunk, proof=proofs[i]))
        return ps

    def __init__(self, header: PartSetHeader):
        self.header = header
        self._mtx = threading.Lock()  # parts, the bit array, the counts
        self.parts: list[Part | None] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header == header

    def add_part(self, part: Part) -> bool:
        """Verify the proof and store (part_set.go AddPart); False for a
        duplicate."""
        part.validate_basic()
        if part.index >= self.header.total:
            raise PartSetError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        if (part.proof.index != part.index
                or part.proof.total != self.header.total):
            raise PartSetError("part proof index/total mismatch")
        try:
            part.proof.verify(self.header.hash, part.bytes_)
        except ValueError as e:
            # a bad proof is a protocol rejection: callers catch
            # PartSetError to drop a bad peer's part
            raise PartSetError(f"invalid part proof: {e}") from e
        return self._store(part)

    def _add_trusted_part(self, part: Part) -> bool:
        """Store a part whose proof this process just computed
        (from_data), without the proof walk; never for parts from the
        wire."""
        part.validate_basic()
        if part.index >= self.header.total:
            raise PartSetError("part index out of range")
        return self._store(part)

    def _store(self, part: Part) -> bool:
        with self._mtx:
            if self.parts[part.index] is not None:
                return False
            self.parts[part.index] = part
            self.parts_bit_array.set_index(part.index, True)
            self.count += 1
            self.byte_size += len(part.bytes_)
            # the lockset sanitizer's seam: PartSet.count is a documented
            # lock-free field in fieldguards.json (a single writer in the
            # reference), so it records an empty guard set
            libsync.lockset_note("PartSet.count")
            return True

    def get_part(self, index: int) -> Part | None:
        return self.parts[index]

    def is_complete(self) -> bool:
        with self._mtx:
            return self.count == self.header.total

    def assemble(self) -> bytes:
        with self._mtx:
            if self.count != self.header.total:
                raise PartSetError("incomplete part set")
            return b"".join(p.bytes_ for p in self.parts)
