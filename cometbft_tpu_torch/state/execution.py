"""Block execution — the consensus→application bridge (reference:
state/execution.go:25-737).

``BlockExecutor`` turns consensus decisions into application state:
``create_proposal_block`` (reap mempool → ABCI PrepareProposal),
``process_proposal``, ``apply_block`` (validate → FinalizeBlock → derive
next State → Commit with the mempool locked → prune → fire events), and
the vote-extension hooks.

``device`` (default the GPU; raises without one) is where ``apply_block``
verifies each LastCommit (state/validation.validate_block). The hashes
the block path takes (the block's and data's, the validator sets', the
results') go through the hash plane that the caller has pushed, if any
(crypto/hashplane).
"""

from __future__ import annotations

import time

from ..abci import types as abci
from ..types import BlockID, ExtendedCommit
from ..types.block import Block
from ..types.event_bus import (
    EventDataNewBlock,
    EventDataNewBlockEvents,
    EventDataNewBlockHeader,
    EventDataTx,
    EventDataValidatorSetUpdates,
    NopEventBus,
)
from ..types.validator_set import (
    Validator,
    ValidatorSet,
    pubkey_proto_encode,
)
from ..crypto import keys as crypto_keys
from ..ops import verify as ov
from .state import State, results_hash
from .validation import validate_block


class NopMempool:
    """Placeholder until the mempool service lands (mempool/)."""

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        return []

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def update(self, height, txs, tx_results, *a, **k) -> None:
        pass


class NopEvidencePool:
    def pending_evidence(self, max_bytes: int) -> list:
        return []

    def update(self, state, evidence_list) -> None:
        pass

    def check_evidence(self, evidence_list) -> None:
        pass


def _commit_info(block: Block, last_validators: ValidatorSet) -> abci.CommitInfo:
    """ABCI view of the block's LastCommit against a given validator set."""
    votes = []
    if block.last_commit is not None and block.last_commit.size() > 0:
        for i, cs in enumerate(block.last_commit.signatures):
            val = last_validators.get_by_index(i)
            votes.append(
                abci.VoteInfo(
                    validator=abci.Validator(
                        address=val.address, power=val.voting_power
                    ),
                    block_id_flag=cs.block_id_flag,
                )
            )
    return abci.CommitInfo(
        round=block.last_commit.round if block.last_commit else 0, votes=votes
    )


def build_last_commit_info(
    block: Block, state_store, state: "State"
) -> abci.CommitInfo:
    """execution.go:405 buildLastCommitInfo — the voter powers the app sees
    for block H must come from the validator set AT height H-1.

    Live path (H == state.last_block_height + 1): state.last_validators IS
    that set, no store I/O. Replay path (handshake replaying an older
    window): load it from the state store — the boot-time in-memory set
    diverges across validator-set changes. A missing store record fails
    loudly rather than handing the app guessed voter powers (the reference
    panics on a failed LoadValidators)."""
    if block.header.height == state.initial_height:
        return abci.CommitInfo(round=0, votes=[])
    if (
        block.header.height == state.last_block_height + 1
        and state.last_validators is not None
    ):
        vals = state.last_validators
    else:
        vals = (
            state_store.load_validators(block.header.height - 1)
            if state_store is not None
            else None
        )
        if vals is None:
            raise RuntimeError(
                f"no validator set stored for height "
                f"{block.header.height - 1}"
            )
    commit_size = block.last_commit.size() if block.last_commit else 0
    if commit_size != len(vals.validators):
        raise RuntimeError(
            f"commit size ({commit_size}) != validator set length "
            f"({len(vals.validators)}) at height {block.header.height}"
        )
    return _commit_info(block, vals)


def extended_commit_info(ec: ExtendedCommit, validators: ValidatorSet):
    votes = []
    for i, es in enumerate(ec.extended_signatures):
        val = validators.get_by_index(i)
        votes.append(
            abci.ExtendedVoteInfo(
                validator=abci.Validator(
                    address=val.address, power=val.voting_power
                ),
                vote_extension=es.extension,
                extension_signature=es.extension_signature,
                block_id_flag=es.commit_sig.block_id_flag,
            )
        )
    return abci.ExtendedCommitInfo(round=ec.round, votes=votes)


def _abci_misbehavior(evidence_list, state: State) -> list[abci.Misbehavior]:
    """types/evidence.go ABCI() — evidence → ABCI Misbehavior records."""
    from ..types.evidence import (
        DuplicateVoteEvidence,
        LightClientAttackEvidence,
    )

    out = []
    for ev in evidence_list or ():
        if isinstance(ev, DuplicateVoteEvidence):
            out.append(
                abci.Misbehavior(
                    type=abci.MisbehaviorType.DUPLICATE_VOTE,
                    validator=abci.Validator(
                        address=ev.vote_a.validator_address,
                        power=ev.validator_power,
                    ),
                    height=ev.height(),
                    time_ns=ev.time_ns(),
                    total_voting_power=ev.total_voting_power,
                )
            )
        elif isinstance(ev, LightClientAttackEvidence):
            for val in ev.byzantine_validators:
                out.append(
                    abci.Misbehavior(
                        type=abci.MisbehaviorType.LIGHT_CLIENT_ATTACK,
                        validator=abci.Validator(
                            address=val.address, power=val.voting_power
                        ),
                        height=ev.height(),
                        time_ns=ev.time_ns(),
                        total_voting_power=ev.total_voting_power,
                    )
                )
    return out


def validate_validator_updates(
    updates: list[abci.ValidatorUpdate], validator_params
) -> None:
    """Reject app validator updates the consensus layer can't carry
    (state/execution.go:515-535 validateValidatorUpdates): negative
    power, key types outside ConsensusParams.validator.pub_key_types,
    and — beyond the params check — types the tendermint.crypto
    .PublicKey oneof cannot wire-encode at all (the valset hash would
    otherwise crash the FSM at the next header; same gate as genesis,
    types/genesis.py)."""
    allowed = tuple(validator_params.pub_key_types)
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu!r}")
        # Decode the key for removals too (the reference's converter
        # does, PB2TM.ValidatorUpdates): a malformed removal must fail
        # HERE with a validation error, not deep inside apply_block.
        try:
            pk = crypto_keys.pubkey_from_type_and_bytes(
                vu.pub_key_type, vu.pub_key_bytes
            )
        except ValueError as e:
            raise ValueError(f"invalid validator update key: {e}") from e
        if vu.power == 0:
            continue  # removal: decoded, but no type admission needed
        if vu.pub_key_type not in allowed:
            raise ValueError(
                f"validator update uses pubkey type {vu.pub_key_type!r},"
                f" which is unsupported for consensus (allowed:"
                f" {allowed})"
            )
        try:
            pubkey_proto_encode(pk)
        except ValueError as e:
            raise ValueError(
                f"validator update key not wire-encodable: {e}"
            ) from e


def validator_updates_to_validators(updates: list[abci.ValidatorUpdate]):
    """ABCI ValidatorUpdate list → Validator list (power 0 = removal).

    Rejects key types the tendermint.crypto.PublicKey oneof cannot
    carry: the reference's converter fails identically inside
    PubKeyFromProto (crypto/encoding/codec.go:41-63), which also guards
    its InitChain/replay path — without this, a non-wire key admitted
    here would crash the FSM at the next validator-set hash."""
    out = []
    for vu in updates:
        pk = crypto_keys.pubkey_from_type_and_bytes(
            vu.pub_key_type, vu.pub_key_bytes
        )
        if vu.power != 0:
            pubkey_proto_encode(pk)  # ValueError for non-wire types
        out.append(Validator(pub_key=pk, voting_power=vu.power))
    return out


class BlockExecutor:
    def __init__(
        self,
        state_store,
        proxy_app,  # consensus-connection ABCI client
        mempool=None,
        evidence_pool=None,
        block_store=None,
        event_bus=None,
        metrics=None,
        *,
        device="cuda",
    ):
        ov.resolve_device(device)
        self.device = device
        self.state_store = state_store
        self.proxy_app = proxy_app
        self.mempool = mempool if mempool is not None else NopMempool()
        self.evidence_pool = (
            evidence_pool if evidence_pool is not None else NopEvidencePool()
        )
        self.block_store = block_store
        self.event_bus = event_bus if event_bus is not None else NopEventBus()
        self.metrics = metrics
        # Pipelined commits (consensus/pipeline.py) set this to the
        # durability barrier: pruning must never outrun the fsynced
        # suffix, or a crash could lose a block the WAL marker claims.
        self.prune_gate = None  # lockfree: set once at pipeline wiring, before the worker starts; read-only afterwards

    # -- proposal ----------------------------------------------------------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_ext_commit: ExtendedCommit | None,
        proposer_address: bytes,
        time_ns: int | None = None,
    ) -> Block:
        """execution.go:101 CreateProposalBlock."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = self.evidence_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes
        )
        # Data budget: block max minus header/commit/evidence overhead
        # (types.MaxDataBytes — approximated; parts cap enforces the rest).
        max_data_bytes = (
            max_bytes - 2048 if max_bytes > 0 else 104857600
        )
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        last_commit = (
            last_ext_commit.to_commit()
            if last_ext_commit is not None
            else None
        )
        if time_ns is None:
            time_ns = time.time_ns()
        rpp = self.proxy_app.prepare_proposal(
            abci.RequestPrepareProposal(
                max_tx_bytes=max_data_bytes,
                txs=list(txs),
                local_last_commit=(
                    extended_commit_info(last_ext_commit, state.last_validators)
                    if last_ext_commit is not None and last_ext_commit.size()
                    else abci.ExtendedCommitInfo(round=0)
                ),
                misbehavior=_abci_misbehavior(evidence, state),
                height=height,
                time_ns=time_ns,
                next_validators_hash=state.next_validators.hash(),
                proposer_address=proposer_address,
            )
        )
        return state.make_block(
            height, list(rpp.txs), last_commit, evidence, proposer_address,
            time_ns,
        )

    def process_proposal(self, block: Block, state: State) -> bool:
        """execution.go:162 ProcessProposal."""
        resp = self.proxy_app.process_proposal(
            abci.RequestProcessProposal(
                txs=list(block.data.txs),
                proposed_last_commit=build_last_commit_info(
                    block, self.state_store, state
                ),
                misbehavior=_abci_misbehavior(block.evidence, state),
                hash=block.hash(),
                height=block.header.height,
                time_ns=block.header.time_ns,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            )
        )
        if resp.status == abci.ProcessProposalStatus.UNKNOWN:
            raise RuntimeError("ProcessProposal returned UNKNOWN status")
        return resp.is_accepted

    # -- validation --------------------------------------------------------

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block, device=self.device)
        self.evidence_pool.check_evidence(block.evidence)

    # -- apply -------------------------------------------------------------

    def finalize_request(
        self, state: State, block: Block
    ) -> abci.RequestFinalizeBlock:
        """The RequestFinalizeBlock apply_block sends — shared with the
        speculative path so both execute bit-identical requests."""
        return abci.RequestFinalizeBlock(
            txs=list(block.data.txs),
            decided_last_commit=build_last_commit_info(
                block, self.state_store, state
            ),
            misbehavior=_abci_misbehavior(block.evidence, state),
            hash=block.hash(),
            height=block.header.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )

    def speculate_block(self, state: State, block: Block):
        """Run FinalizeBlock speculatively (consensus/pipeline.py's
        cs-spec-exec worker): the app comes out unchanged; returns
        ``(resp, post_token)`` for a later winning ``complete_apply``.
        Raises abci.client.SpeculationUnsupported on remote transports or
        apps without the snapshot/restore extension. The caller validated
        this exact block before prevoting it — speculation never runs an
        unvalidated block."""
        resp, post = self.proxy_app.speculate_finalize(
            self.finalize_request(state, block)
        )
        if len(resp.tx_results) != len(block.data.txs):
            raise RuntimeError(
                "speculative FinalizeBlock returned wrong number of "
                "tx results"
            )
        return resp, post

    def apply_block(
        self, state: State, block_id: BlockID, block: Block
    ) -> State:
        """execution.go:204 ApplyBlock: validate → FinalizeBlock → update
        state → Commit → prune → events. Returns the next State."""
        t0 = time.perf_counter()
        self.validate_block(state, block)
        new_state, resp = self.begin_apply(state, block_id, block)
        self.complete_apply(new_state, block_id, block, resp, t0=t0)
        return new_state

    def begin_apply(
        self, state: State, block_id: BlockID, block: Block, spec_resp=None
    ):
        """The FSM-side half of ApplyBlock: FinalizeBlock (or the
        memoized speculative response), response persistence, and the
        pure State(H+1) derivation. Returns ``(new_state, resp)``; no
        durable app/consensus state advances — ``complete_apply`` owns
        that, so a pipelined caller may run it on the commit-writer
        worker AFTER the block itself is durable (the handshake refuses
        an app ahead of the block store, consensus/replay.py)."""
        if spec_resp is not None:
            resp = spec_resp
        else:
            resp = self.proxy_app.finalize_block(
                self.finalize_request(state, block)
            )
        if len(resp.tx_results) != len(block.data.txs):
            raise RuntimeError(
                "FinalizeBlock returned wrong number of tx results"
            )
        from ..libs.fail import fail_point

        fail_point("exec-after-finalize")

        self.state_store.save_finalize_block_response(
            block.header.height, resp
        )
        fail_point("exec-after-save-responses")

        new_state = self._update_state(state, block_id, block, resp)
        new_state.app_hash = resp.app_hash
        return new_state, resp

    def complete_apply(
        self,
        new_state: State,
        block_id: BlockID,
        block: Block,
        resp,
        spec_token=None,
        t0: float | None = None,
    ) -> None:
        """The durable half of ApplyBlock: app Commit (mempool locked),
        state persistence, evidence update, pruning, events. A winning
        speculation passes ``spec_token`` — the memoized post-finalize
        app state is restored in place of re-execution, then Commit
        persists it."""
        if spec_token is not None:
            self.proxy_app.apply_speculation(spec_token)
        # Commit: lock mempool so no CheckTx races the app's state commit
        # (execution.go:360).
        app_hash = self._commit(new_state, block, resp)
        assert app_hash is not None

        self.state_store.save(new_state)

        self.evidence_pool.update(new_state, block.evidence)
        self._prune(new_state)
        self._fire_events(block, block_id, resp)
        if self.metrics is not None and t0 is not None:
            self.metrics.block_processing_time.observe(
                time.perf_counter() - t0
            )

    def _commit(self, state: State, block: Block, resp) -> bytes:
        self.mempool.lock()
        try:
            cres = self.proxy_app.commit()
            self.mempool.update(
                block.header.height,
                list(block.data.txs),
                list(resp.tx_results),
            )
            self._retain_height = cres.retain_height
            return resp.app_hash
        finally:
            self.mempool.unlock()

    def _prune(self, state: State) -> None:
        retain = getattr(self, "_retain_height", 0)
        if retain > 0 and self.prune_gate is not None:
            # never prune past the durability barrier: the pruned block
            # must not be the one a crash replay would need to re-serve
            retain = min(retain, self.prune_gate())
        if retain > 0 and self.block_store is not None:
            base = self.block_store.base()
            if retain > base:
                pruned = self.block_store.prune_blocks(retain)
                if pruned > 0:
                    self.state_store.prune_states(retain)

    def _update_state(
        self, state: State, block_id: BlockID, block: Block, resp
    ) -> State:
        """execution.go:541 updateState — derive State(H+1)."""
        height = block.header.height
        next_vals = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if resp.validator_updates:
            # validated against the params IN FORCE for this height
            # (the reference passes state.ConsensusParams.Validator)
            validate_validator_updates(
                resp.validator_updates, state.consensus_params.validator
            )
            changes = validator_updates_to_validators(resp.validator_updates)
            next_vals.update_with_change_set(changes)
            last_height_vals_changed = height + 1 + 1

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        if resp.consensus_param_updates is not None:
            params = params.update(resp.consensus_param_updates)
            params.validate_basic()
            last_height_params_changed = height + 1

        # validators(H+1) = previous next_validators (unchanged); updates
        # land in next_validators(H+2) with rotated priorities
        # (execution.go updateState: nValSet).
        next_vals.increment_proposer_priority(1)
        return State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            next_validators=next_vals,
            validators=state.next_validators.copy(),
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash(resp.tx_results),
            app_hash=b"",  # filled after Commit
            app_version=params.version.app,
        )

    def _fire_events(self, block: Block, block_id: BlockID, resp) -> None:
        """execution.go:614 fireEvents."""
        self.event_bus.publish_new_block(
            EventDataNewBlock(
                block=block, block_id=block_id, result_finalize_block=resp
            )
        )
        self.event_bus.publish_new_block_header(
            EventDataNewBlockHeader(header=block.header)
        )
        # Unconditional (execution.go fireEvents): block.height must be
        # searchable even when the app emitted no block-level events.
        self.event_bus.publish_new_block_events(
            EventDataNewBlockEvents(
                height=block.header.height,
                events=list(resp.events or []),
                num_txs=len(block.data.txs),
            )
        )
        for i, tx in enumerate(block.data.txs):
            self.event_bus.publish_tx(
                EventDataTx(
                    height=block.header.height,
                    index=i,
                    tx=tx,
                    result=resp.tx_results[i],
                )
            )
        if resp.validator_updates:
            self.event_bus.publish_validator_set_updates(
                EventDataValidatorSetUpdates(
                    validator_updates=list(resp.validator_updates)
                )
            )

    # -- vote extensions ---------------------------------------------------

    def extend_vote(self, vote, state: State) -> bytes:
        resp = self.proxy_app.extend_vote(
            abci.RequestExtendVote(
                hash=vote.block_id.hash,
                height=vote.height,
            )
        )
        return resp.vote_extension

    def verify_vote_extension(self, vote, state: State) -> bool:
        resp = self.proxy_app.verify_vote_extension(
            abci.RequestVerifyVoteExtension(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
            )
        )
        if resp.status == abci.VerifyVoteExtensionStatus.UNKNOWN:
            raise RuntimeError("VerifyVoteExtension returned UNKNOWN")
        return resp.is_accepted
