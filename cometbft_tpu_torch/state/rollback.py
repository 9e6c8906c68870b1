"""State rollback (reference: state/rollback.go + commands/rollback.go).

Removes the effects of the LAST block from the state store — the recovery
tool for an app-hash divergence after an app upgrade bug: roll the state
back one height, optionally delete the offending block, fix the app,
restart, and the node re-applies it.
"""

from __future__ import annotations


class RollbackError(Exception):
    pass


def rollback_state(state_store, block_store, remove_block: bool = False):
    """Roll the state back one height; returns (new_height, app_hash).

    reference rollback.go Rollback: the rolled-back state's fields come
    from the PREVIOUS block's header plus the stored validator sets.
    """
    from dataclasses import replace

    state = state_store.load()
    if state is None:
        raise RollbackError("no state found to roll back")
    height = state.last_block_height
    if height <= state.initial_height:
        raise RollbackError(
            f"state at initial height {height}, nothing to roll back"
        )
    rollback_height = height - 1
    prev_meta = block_store.load_block_meta(rollback_height)
    removed_meta = block_store.load_block_meta(height)
    if prev_meta is None or removed_meta is None:
        raise RollbackError(
            f"blocks at heights {rollback_height},{height} not found, "
            f"cannot roll back"
        )
    # Validator window: state.validators is the set validating block
    # last_block_height+1 (the store keys them that way), so the
    # rolled-back state wants sets for height, height+1 and
    # rollback_height respectively (rollback.go).
    validators = state_store.load_validators(height)
    next_validators = state_store.load_validators(height + 1)
    last_validators = state_store.load_validators(rollback_height)
    if validators is None or next_validators is None:
        raise RollbackError("validator sets for rollback height missing")
    if last_validators is None:
        last_validators = validators
    new_state = replace(
        state,
        last_block_height=rollback_height,
        last_block_id=prev_meta.block_id,
        last_block_time_ns=prev_meta.header.time_ns,
        validators=validators,
        next_validators=next_validators,
        last_validators=last_validators,
        # app hash and last-results hash are only agreed upon in the
        # FOLLOWING block, i.e. the removed block's header (rollback.go)
        app_hash=removed_meta.header.app_hash,
        last_results_hash=removed_meta.header.last_results_hash,
    )
    state_store.save(new_state)
    if remove_block:
        block_store.delete_block(height)
    return rollback_height, new_state.app_hash
