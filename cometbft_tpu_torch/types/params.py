"""Consensus parameters (reference: types/params.go).

Hashed into Header.ConsensusHash; updatable by the ABCI app per block.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace

from ..crypto import tmhash
from . import proto

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB
MAX_BLOCK_PARTS = 1601
MAX_EVIDENCE_BYTES_DENOM = 3


@dataclass(frozen=True, slots=True)
class BlockParams:
    max_bytes: int = 22020096  # 21MB
    max_gas: int = -1


@dataclass(frozen=True, slots=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1048576


@dataclass(frozen=True, slots=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = ("ed25519",)


@dataclass(frozen=True, slots=True)
class VersionParams:
    app: int = 0


@dataclass(frozen=True, slots=True)
class ABCIParams:
    vote_extensions_enable_height: int = 0


@dataclass(frozen=True, slots=True)
class ConsensusParams:
    block: BlockParams = dc_field(default_factory=BlockParams)
    evidence: EvidenceParams = dc_field(default_factory=EvidenceParams)
    validator: ValidatorParams = dc_field(default_factory=ValidatorParams)
    version: VersionParams = dc_field(default_factory=VersionParams)
    abci: ABCIParams = dc_field(default_factory=ABCIParams)

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.abci.vote_extensions_enable_height
        return h != 0 and height >= h

    def hash(self) -> bytes:
        """SHA-256 of the HashedParams subset (types/params.go Hash —
        only block max_bytes/max_gas feed the hash, by protocol spec)."""
        body = proto.field_varint(1, self.block.max_bytes) + proto.field_varint(
            2, self.block.max_gas & 0xFFFFFFFFFFFFFFFF
            if self.block.max_gas < 0
            else self.block.max_gas,
        )
        return tmhash.sum(body)

    def validate_basic(self) -> None:
        if self.block.max_bytes == 0 or self.block.max_bytes < -1:
            raise ValueError("block.max_bytes must be -1 or positive")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.max_bytes too large")
        if self.block.max_gas < -1:
            raise ValueError("block.max_gas must be >= -1")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be positive")
        if self.evidence.max_bytes < 0:
            raise ValueError("evidence.max_bytes must be non-negative")
        if not self.validator.pub_key_types:
            raise ValueError("validator.pub_key_types cannot be empty")
        if self.abci.vote_extensions_enable_height < 0:
            raise ValueError("abci.vote_extensions_enable_height negative")

    def update(self, updates) -> "ConsensusParams":
        """Apply an ABCI ConsensusParams update (partial)."""
        if updates is None:
            return self
        out = self
        for section in ("block", "evidence", "validator", "version", "abci"):
            upd = getattr(updates, section, None)
            if upd is not None:
                out = replace(out, **{section: upd})
        return out
