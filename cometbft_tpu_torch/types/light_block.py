"""SignedHeader and LightBlock, the light client's data model.

Reference: types/light.go (LightBlock, SignedHeader): a header, the
commit that signed it, and the validator set the commit is checked
against.
"""

from __future__ import annotations

from dataclasses import dataclass

from .block import Commit, Header
from .validator_set import ValidatorSet


class LightBlockError(Exception):
    pass


@dataclass(frozen=True, slots=True)
class SignedHeader:
    """Header plus the commit that finalized it (types/light.go:118)."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def chain_id(self) -> str:
        return self.header.chain_id

    @property
    def time_ns(self) -> int:
        return self.header.time_ns

    def hash(self) -> bytes | None:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go SignedHeader.ValidateBasic: header and commit
        present, chain id and height matching, the commit signs THIS
        header."""
        if self.header is None:
            raise LightBlockError("missing header")
        if self.commit is None:
            raise LightBlockError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise LightBlockError(
                f"header chain id {self.header.chain_id!r} != {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise LightBlockError(
                f"commit height {self.commit.height} != header height "
                f"{self.header.height}"
            )
        if self.commit.block_id.hash != self.header.hash():
            raise LightBlockError(
                "commit signs a different header "
                f"({self.commit.block_id.hash.hex()} != "
                f"{(self.header.hash() or b'').hex()})"
            )


@dataclass(frozen=True, slots=True)
class LightBlock:
    """SignedHeader + the validator set of that height (types/light.go:28)."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def time_ns(self) -> int:
        return self.signed_header.time_ns

    def hash(self) -> bytes | None:
        return self.signed_header.hash()

    def validate_basic(self, chain_id: str) -> None:
        if self.signed_header is None:
            raise LightBlockError("missing signed header")
        if self.validator_set is None:
            raise LightBlockError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        vals_hash = self.validator_set.hash()
        if self.signed_header.header.validators_hash != vals_hash:
            raise LightBlockError(
                "validator set does not match header validators_hash"
            )
