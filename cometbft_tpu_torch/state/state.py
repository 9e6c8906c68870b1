"""The replicated state snapshot (reference: state/state.go:355).

``State`` is the deterministic summary a node carries between blocks:
the validator-set window (last/current/next), consensus params, and the
app hash + results hash of the latest block. It is treated as immutable —
``BlockExecutor.apply_block`` derives the next State rather than mutating.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace

from ..crypto import merkle
from ..types import (
    Block,
    BlockID,
    Commit,
    ConsensusParams,
    GenesisDoc,
    NIL_BLOCK_ID,
    Version,
    make_block,
)
from ..types.validator_set import ValidatorSet

# Version of the state-machine replication protocol this framework speaks
# (reference: version/version.go TMCoreSemVer + ABCI semver).
SOFTWARE_VERSION = "cometbft-tpu/0.1.0"
BLOCK_PROTOCOL = 11
ABCI_SEMVER = "2.0.0"


@dataclass(slots=True)
class State:
    chain_id: str
    initial_height: int

    last_block_height: int = 0
    last_block_id: BlockID = dc_field(default_factory=BlockID)
    last_block_time_ns: int = 0

    # Validator window: validators(H+1), validators(H), validators(H-1)
    next_validators: ValidatorSet | None = None
    validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = dc_field(
        default_factory=ConsensusParams
    )
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""
    app_version: int = 0

    def is_empty(self) -> bool:
        return self.validators is None

    def copy(self) -> "State":
        return replace(self)

    # -- block construction ------------------------------------------------

    def make_block(
        self,
        height: int,
        txs: list[bytes],
        last_commit: Commit | None,
        evidence: list,
        proposer_address: bytes,
        time_ns: int,
    ) -> Block:
        """Header fields derived from this state (state/state.go MakeBlock)."""
        return make_block(
            height=height,
            txs=txs,
            last_commit=last_commit,
            evidence=evidence,
            header_fields=dict(
                version=Version(block=BLOCK_PROTOCOL, app=self.app_version),
                chain_id=self.chain_id,
                time_ns=time_ns,
                last_block_id=self.last_block_id,
                validators_hash=self.validators.hash(),
                next_validators_hash=self.next_validators.hash(),
                consensus_hash=self.consensus_params.hash(),
                app_hash=self.app_hash,
                last_results_hash=self.last_results_hash,
                proposer_address=proposer_address,
            ),
        )


def make_genesis_state(genesis: GenesisDoc) -> State:
    """state/state.go MakeGenesisState."""
    genesis.validate_and_complete()
    if genesis.validators:
        validators = genesis.validator_set()
        next_validators = validators.copy_increment_proposer_priority(1)
    else:
        # Validators arrive from ABCI InitChain.
        validators = ValidatorSet([])
        next_validators = ValidatorSet([])
    return State(
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        last_block_height=0,
        last_block_id=NIL_BLOCK_ID,
        last_block_time_ns=genesis.genesis_time_ns,
        next_validators=next_validators,
        validators=validators,
        last_validators=ValidatorSet([]),
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=genesis.initial_height,
        app_hash=genesis.app_hash,
        app_version=genesis.consensus_params.version.app,
    )


def results_hash(tx_results: list) -> bytes:
    """Merkle root over deterministic ExecTxResult encodings
    (reference: types/results.go ABCIResults.Hash — only code/data feed
    the hash via the deterministic proto subset)."""
    from ..types import proto

    leaves = []
    for r in tx_results:
        body = b""
        if r.code:
            body += proto.field_varint(1, r.code)
        body += proto.field_bytes(2, r.data)
        if r.gas_wanted:
            body += proto.field_varint(5, r.gas_wanted)
        if r.gas_used:
            body += proto.field_varint(6, r.gas_used)
        leaves.append(body)
    return merkle.hash_from_byte_slices(leaves)
