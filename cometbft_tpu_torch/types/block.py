"""Block, Data, Header, Commit, CommitSig, BlockID, PartSetHeader,
ExtendedCommit and BlockMeta (types/block.go, types/block_meta.go).

Header.hash is the RFC-6962 merkle root of the proto-encoded fields
(types/block.go:439-474), scalar fields wrapped in gogotypes value
wrappers (types/encoding_helper.go's cdcEncode), time a
google.protobuf.Timestamp.

Time is integer nanoseconds since the Unix epoch throughout (Go's
time.Time has ns precision; Python datetime does not).

Data.hash pre-hashes its txs in one batch and takes the merkle root of the
32-byte keys; both, and every other merkle root here, go through the hash
plane when one is routed (crypto/hashplane.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..crypto import hashplane, merkle, tmhash
from . import canonical, proto

MAX_HEADER_BYTES = 626
BLOCK_PART_SIZE_BYTES = 65536  # types/part_set.go part size

# BlockIDFlag (types/block.go:574-583)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True, slots=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return proto.field_varint(1, self.total) + proto.field_bytes(
            2, self.hash
        )

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative part-set total")
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("part-set hash must be 32 bytes")


@dataclass(frozen=True, slots=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = dc_field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def encode(self) -> bytes:
        """BlockID proto body; part_set_header is nullable=false."""
        return proto.field_bytes(1, self.hash) + proto.field_message(
            2, self.part_set_header.encode(), always=True
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("block-id hash must be 32 bytes")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        return self.hash + self.part_set_header.hash + bytes(
            [self.part_set_header.total & 0xFF]
        )


NIL_BLOCK_ID = BlockID()


def cdc_encode_string(s: str) -> bytes:
    """gogotypes.StringValue wrapper (types/encoding_helper.go)."""
    return proto.field_string(1, s) if s else b""


def cdc_encode_int64(v: int) -> bytes:
    return proto.field_varint(1, v) if v else b""


def cdc_encode_bytes(b: bytes) -> bytes:
    return proto.field_bytes(1, b) if b else b""


@dataclass(frozen=True, slots=True)
class Version:
    """Consensus version (proto/tendermint/version/types.proto)."""

    block: int = 11
    app: int = 0

    def encode(self) -> bytes:
        return proto.field_varint(1, self.block) + proto.field_varint(
            2, self.app
        )


@dataclass(frozen=True, slots=True)
class Header:
    """Block header (types/block.go:323-350)."""

    version: Version
    chain_id: str
    height: int
    time_ns: int
    last_block_id: BlockID
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes

    def hash(self) -> bytes | None:
        """Merkle root over the encoded fields (types/block.go:439-474);
        None without a validators hash, as in the reference."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices(
            [
                self.version.encode(),
                cdc_encode_string(self.chain_id),
                cdc_encode_int64(self.height),
                proto.timestamp(self.time_ns),
                self.last_block_id.encode(),
                cdc_encode_bytes(self.last_commit_hash),
                cdc_encode_bytes(self.data_hash),
                cdc_encode_bytes(self.validators_hash),
                cdc_encode_bytes(self.next_validators_hash),
                cdc_encode_bytes(self.consensus_hash),
                cdc_encode_bytes(self.app_hash),
                cdc_encode_bytes(self.last_results_hash),
                cdc_encode_bytes(self.evidence_hash),
                cdc_encode_bytes(self.proposer_address),
            ]
        )

    def validate_basic(self) -> None:
        if len(self.chain_id) > 50:
            raise ValueError("chain id too long")
        if self.height < 0:
            raise ValueError("negative height")
        self.last_block_id.validate_basic()
        for name in (
            "last_commit_hash",
            "data_hash",
            "validators_hash",
            "next_validators_hash",
            "consensus_hash",
            "last_results_hash",
            "evidence_hash",
        ):
            v = getattr(self, name)
            if v and len(v) != tmhash.SIZE:
                raise ValueError(f"{name} must be 32 bytes")
        if len(self.proposer_address) != tmhash.TRUNCATED_SIZE:
            raise ValueError("proposer address must be 20 bytes")


@dataclass(frozen=True, slots=True)
class CommitSig:
    """One validator's slot in a commit (types/block.go:592-606)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = proto.ZERO_TIME_NS
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig voted for (types/block.go:632-644)."""
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            return NIL_BLOCK_ID
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag == BLOCK_ID_FLAG_NIL:
            return NIL_BLOCK_ID
        raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")

    def encode(self) -> bytes:
        return (
            proto.field_varint(1, self.block_id_flag)
            + proto.field_bytes(2, self.validator_address)
            + proto.field_message(
                3, proto.timestamp(self.timestamp_ns), always=True
            )
            + proto.field_bytes(4, self.signature)
        )

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError("unknown block-id flag")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address or self.signature:
                raise ValueError("absent commit sig must be empty")
        else:
            if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
                raise ValueError("validator address must be 20 bytes")
            if not self.signature or len(self.signature) > 64:
                raise ValueError("bad signature length")


@dataclass(slots=True)
class Commit:
    """+2/3 precommits for a block (types/block.go:715+)."""

    height: int
    round: int
    block_id: BlockID
    signatures: list[CommitSig]

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Sign bytes of validator ``val_idx``'s precommit in this commit
        (types/block.go:871-883 — only the timestamp differs per validator).
        """
        cs = self.signatures[val_idx]
        return canonical.vote_sign_bytes(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            cs.block_id(self.block_id),
            cs.timestamp_ns,
        )

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [cs.encode() for cs in self.signatures]
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()


@dataclass(frozen=True, slots=True)
class ExtendedCommitSig:
    """A CommitSig and the vote extension it carried (types/block.go:646+)."""

    commit_sig: CommitSig
    extension: bytes = b""
    extension_signature: bytes = b""

    def validate_basic(self) -> None:
        self.commit_sig.validate_basic()
        if self.commit_sig.block_id_flag != BLOCK_ID_FLAG_COMMIT and (
            self.extension or self.extension_signature
        ):
            raise ValueError("non-commit sig cannot carry an extension")

    def ensure_extension(self) -> None:
        if (
            self.commit_sig.block_id_flag == BLOCK_ID_FLAG_COMMIT
            and not self.extension_signature
        ):
            raise ValueError("commit sig missing required vote extension")


@dataclass(slots=True)
class ExtendedCommit:
    """A Commit with the vote extensions, kept so that a restarted
    proposer can hand them to PrepareProposal (types/block.go:736+)."""

    height: int
    round: int
    block_id: BlockID
    extended_signatures: list[ExtendedCommitSig]

    def to_commit(self) -> Commit:
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[es.commit_sig for es in self.extended_signatures],
        )

    def size(self) -> int:
        return len(self.extended_signatures)

    def ensure_extensions(self, required: bool) -> None:
        if required:
            for es in self.extended_signatures:
                es.ensure_extension()

    def validate_basic(self) -> None:
        self.to_commit().validate_basic()
        for es in self.extended_signatures:
            es.validate_basic()


@dataclass(slots=True)
class Data:
    """Block transactions; the hash is the merkle root of the tx hashes."""

    txs: list[bytes] = dc_field(default_factory=list)

    def hash(self) -> bytes:
        # the tx keys are one flat batch (the hash plane's best shape); the
        # merkle levels over them route level by level
        return merkle.hash_from_byte_slices(hashplane.hash_many(self.txs))


@dataclass(slots=True)
class Block:
    """Header, txs, evidence and the previous block's commit."""

    header: Header
    data: Data
    evidence: list = dc_field(default_factory=list)
    last_commit: Commit | None = None

    def hash(self) -> bytes | None:
        return self.header.hash()

    def validate_basic(self) -> None:
        from .evidence import evidence_list_hash

        self.header.validate_basic()
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("block above height 1 needs last commit")
            self.last_commit.validate_basic()
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError("last commit hash mismatch")
        if self.header.data_hash != self.data.hash():
            raise ValueError("data hash mismatch")
        for ev in self.evidence:
            ev.validate_basic()
        # the evidence section against the committed header hash
        # (types/block.go:98)
        if self.header.evidence_hash != evidence_list_hash(self.evidence):
            raise ValueError("evidence hash mismatch")


@dataclass(slots=True)
class BlockMeta:
    """The summary stored for each height (types/block_meta.go)."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int


def make_block(height: int, txs: list[bytes], last_commit: Commit | None,
               evidence: list, header_fields: dict) -> Block:
    """Assemble a block and fill its derived hashes (types/block.go
    MakeBlock + fillHeader)."""
    from .evidence import evidence_list_hash

    data = Data(txs=list(txs))
    header = Header(
        height=height,
        data_hash=data.hash(),
        last_commit_hash=(
            last_commit.hash()
            if last_commit is not None
            else merkle.hash_from_byte_slices([])
        ),
        evidence_hash=evidence_list_hash(evidence),
        **header_fields,
    )
    return Block(header=header, data=data, evidence=evidence,
                 last_commit=last_commit)
