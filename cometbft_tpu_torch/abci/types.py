"""ABCI 2.0 request/response types (reference: abci/types/types.pb.go,
proto/tendermint/abci/types.proto).

Dataclass mirrors of the protobuf messages the 14-method ``Application``
interface exchanges. Field names follow the proto definitions; enums keep
the proto numeric values so a wire codec can round-trip them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

OK = 0  # response code for success (abci/types/result.go)


class CheckTxType(IntEnum):
    NEW = 0
    RECHECK = 1


class ProcessProposalStatus(IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class VerifyVoteExtensionStatus(IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class OfferSnapshotResult(IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


class ApplySnapshotChunkResult(IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


class MisbehaviorType(IntEnum):
    UNKNOWN = 0
    DUPLICATE_VOTE = 1
    LIGHT_CLIENT_ATTACK = 2


# -- shared sub-messages ---------------------------------------------------


@dataclass
class EventAttribute:
    key: str
    value: str
    index: bool = False


@dataclass
class Event:
    type: str
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ExecTxResult:
    code: int = OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == OK


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass
class Validator:
    address: bytes
    power: int


@dataclass
class VoteInfo:
    validator: Validator
    block_id_flag: int  # types.BlockIDFlag numeric value


@dataclass
class ExtendedVoteInfo:
    validator: Validator
    vote_extension: bytes
    extension_signature: bytes
    block_id_flag: int


@dataclass
class CommitInfo:
    round: int
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round: int
    votes: list[ExtendedVoteInfo] = field(default_factory=list)


@dataclass
class Misbehavior:
    type: MisbehaviorType
    validator: Validator
    height: int
    time_ns: int
    total_voting_power: int


@dataclass
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


# -- requests / responses --------------------------------------------------


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: object | None = None  # types.ConsensusParams
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class ResponseInitChain:
    consensus_params: object | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class ResponseQuery:
    code: int = OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: list | None = None
    height: int = 0
    codespace: str = ""


@dataclass
class RequestCheckTx:
    tx: bytes
    type: CheckTxType = CheckTxType.NEW


@dataclass
class ResponseCheckTx:
    code: int = OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == OK


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int
    txs: list[bytes]
    local_last_commit: ExtendedCommitInfo
    misbehavior: list[Misbehavior]
    height: int
    time_ns: int
    next_validators_hash: bytes
    proposer_address: bytes


@dataclass
class ResponsePrepareProposal:
    txs: list[bytes] = field(default_factory=list)


@dataclass
class RequestProcessProposal:
    txs: list[bytes]
    proposed_last_commit: CommitInfo
    misbehavior: list[Misbehavior]
    hash: bytes
    height: int
    time_ns: int
    next_validators_hash: bytes
    proposer_address: bytes


@dataclass
class ResponseProcessProposal:
    status: ProcessProposalStatus = ProcessProposalStatus.UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == ProcessProposalStatus.ACCEPT


@dataclass
class RequestExtendVote:
    hash: bytes
    height: int
    time_ns: int = 0
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo | None = None
    misbehavior: list[Misbehavior] = field(default_factory=list)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponseExtendVote:
    vote_extension: bytes = b""


@dataclass
class RequestVerifyVoteExtension:
    hash: bytes
    validator_address: bytes
    height: int
    vote_extension: bytes


@dataclass
class ResponseVerifyVoteExtension:
    status: VerifyVoteExtensionStatus = VerifyVoteExtensionStatus.UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == VerifyVoteExtensionStatus.ACCEPT


@dataclass
class RequestFinalizeBlock:
    txs: list[bytes]
    decided_last_commit: CommitInfo
    misbehavior: list[Misbehavior]
    hash: bytes
    height: int
    time_ns: int
    next_validators_hash: bytes
    proposer_address: bytes


@dataclass
class ResponseFinalizeBlock:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object | None = None
    app_hash: bytes = b""


@dataclass
class RequestCommit:
    pass


@dataclass
class ResponseCommit:
    retain_height: int = 0


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class ResponseListSnapshots:
    snapshots: list[Snapshot] = field(default_factory=list)


@dataclass
class RequestOfferSnapshot:
    snapshot: Snapshot
    app_hash: bytes


@dataclass
class ResponseOfferSnapshot:
    result: OfferSnapshotResult = OfferSnapshotResult.UNKNOWN


@dataclass
class RequestLoadSnapshotChunk:
    height: int
    format: int
    chunk: int


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class RequestApplySnapshotChunk:
    index: int
    chunk: bytes
    sender: str = ""


@dataclass
class ResponseApplySnapshotChunk:
    result: ApplySnapshotChunkResult = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)
