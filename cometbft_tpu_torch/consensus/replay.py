"""ABCI handshake replay (reference: consensus/replay.go:242-516).

On boot the application may be behind the block store (crash between
SaveBlock and Commit) or brand new (statesync'd node store, wiped app
dir). ``Handshaker.handshake`` asks the app where it is via ABCI ``Info``
and replays the missing blocks from the store — FinalizeBlock+Commit
without re-validation for fully-committed heights, the full
``BlockExecutor.apply_block`` path for a stored-but-unapplied tip.
"""

from __future__ import annotations

import json

from ..abci import types as abci
from ..state.execution import (
    build_last_commit_info,
    validator_updates_to_validators,
)
from ..types import GenesisDoc
from ..types.validator_set import ValidatorSet


class HandshakeError(Exception):
    pass


def exec_commit_block(proxy_app, block, state, store=None) -> bytes:
    """state/execution.go:679 ExecCommitBlock — replay one stored block
    through FinalizeBlock+Commit, no validation, no events.

    DecidedLastCommit is built from the validator set at height-1 loaded
    from the state store (buildLastCommitInfo), NOT the boot-time
    state.last_validators — they diverge when the replayed window spans
    validator-set changes.
    """
    resp = proxy_app.finalize_block(
        abci.RequestFinalizeBlock(
            txs=list(block.data.txs),
            decided_last_commit=build_last_commit_info(block, store, state),
            misbehavior=[],
            hash=block.hash(),
            height=block.header.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
    )
    if store is not None:
        store.save_finalize_block_response(block.header.height, resp)
    proxy_app.commit()
    return resp.app_hash


class Handshaker:
    def __init__(
        self,
        state_store,
        state,  # sm.State loaded from disk (or genesis)
        block_store,
        genesis_doc: GenesisDoc,
        block_exec=None,  # needed only for the stored-but-unapplied tip
    ):
        self.state_store = state_store
        self.state = state
        self.block_store = block_store
        self.genesis = genesis_doc
        self.block_exec = block_exec
        self.n_blocks = 0

    def handshake(self, app_conns) -> bytes:
        """replay.go:242 — Info on the query connection, then ReplayBlocks
        on the consensus connection. Returns the final app hash."""
        info = app_conns.query.info(
            abci.RequestInfo(abci_version="2.0.0", block_version=11)
        )
        app_hash = self.replay_blocks(
            info.last_block_app_hash, info.last_block_height, app_conns
        )
        return app_hash

    # -- replay.go:285 ReplayBlocks ----------------------------------------

    def replay_blocks(
        self, app_hash: bytes, app_height: int, app_conns
    ) -> bytes:
        store_height = self.block_store.height()
        store_base = self.block_store.base()
        state_height = self.state.last_block_height
        state = self.state

        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")

        # Fresh chain: InitChain with the genesis validator set.
        if app_height == 0:
            res = app_conns.consensus.init_chain(
                abci.RequestInitChain(
                    time_ns=self.genesis.genesis_time_ns,
                    chain_id=self.genesis.chain_id,
                    consensus_params=self.genesis.consensus_params,
                    validators=[
                        abci.ValidatorUpdate(
                            gv.pub_key.type, gv.pub_key.bytes(), gv.power
                        )
                        for gv in self.genesis.validators
                    ],
                    app_state_bytes=json.dumps(
                        self.genesis.app_state
                    ).encode(),
                    initial_height=self.genesis.initial_height,
                )
            )
            if state_height == 0:  # only overwrite genesis-derived state
                if res.app_hash:
                    state.app_hash = res.app_hash
                if res.validators:
                    vals = ValidatorSet(
                        validator_updates_to_validators(res.validators)
                    )
                    state.validators = vals
                    state.next_validators = vals.copy_increment_proposer_priority(1)
                elif not self.genesis.validators:
                    raise HandshakeError(
                        "validator set is nil in genesis and InitChain"
                    )
                if res.consensus_params is not None:
                    state.consensus_params = res.consensus_params
                self.state_store.save(state)
                app_hash = state.app_hash

        if store_height == 0:
            return app_hash

        if app_height > 0 and app_height < store_base - 1:
            raise HandshakeError(
                f"app height {app_height} below block store base {store_base}"
            )
        if store_height < app_height:
            raise HandshakeError(
                f"app is ahead of the block store: {app_height} > {store_height}"
            )
        if store_height < state_height:
            raise HandshakeError(
                f"state height {state_height} ahead of store {store_height}"
            )
        if store_height > state_height + 1:
            raise HandshakeError(
                f"store height {store_height} more than one above state "
                f"{state_height}"
            )

        # Replay fully-committed heights the app is missing.
        replay_until = (
            state_height  # the tip (if unapplied) goes through apply_block
            if store_height == state_height + 1
            else store_height
        )
        for height in range(app_height + 1, replay_until + 1):
            block = self.block_store.load_block(height)
            if block is None:
                raise HandshakeError(f"missing block {height} in store")
            app_hash = exec_commit_block(
                app_conns.consensus, block, state, self.state_store
            )
            self.n_blocks += 1

        # Stored-but-unapplied tip: full apply (validates, saves state).
        if store_height == state_height + 1:
            block = self.block_store.load_block(store_height)
            meta = self.block_store.load_block_meta(store_height)
            if self.block_exec is None:
                raise HandshakeError(
                    "unapplied tip block requires a block executor"
                )
            if app_height == store_height:
                # App already has it; just sync our state via replay of
                # the responses (light path): recompute state only.
                resp = self.state_store.load_finalize_block_response(
                    store_height
                )
                if resp is None:
                    raise HandshakeError(
                        f"app at {app_height} but no stored responses"
                    )
                new_state = self.block_exec._update_state(
                    state, meta.block_id, block, resp
                )
                new_state.app_hash = app_hash
                self.state_store.save(new_state)
                self.state = new_state
            else:
                new_state = self.block_exec.apply_block(
                    state, meta.block_id, block
                )
                self.state = new_state
                app_hash = new_state.app_hash
            self.n_blocks += 1

        return app_hash
