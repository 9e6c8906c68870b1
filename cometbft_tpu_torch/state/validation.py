"""Full block validation against state (reference: state/validation.go:150).

Everything a node checks before applying a block: header fields derived
from state must match, and the embedded LastCommit must carry +2/3 of the
previous validator set: the batch-verified hot path (validation.go:92 ->
types/validation.go:26 -> crypto/batch -> K2 on ``device`` through the
process-wide arena, X1 building the keys it lacks; below the verify cut
the native host batch). ``device`` defaults to the GPU and raises without
one, whatever the commit's size; tests pass ``device="cpu"``.
"""

from __future__ import annotations

from ..ops import verify as ov
from ..types import validation as tv
from ..types.block import Block
from .state import State


class BlockValidationError(Exception):
    pass


def validate_block(state: State, block: Block, device="cuda") -> None:
    ov.resolve_device(device)
    block.validate_basic()

    hdr = block.header
    if hdr.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong chain id {hdr.chain_id!r}, want {state.chain_id!r}"
        )
    expected_height = (
        state.last_block_height + 1
        if state.last_block_height > 0
        else state.initial_height
    )
    if hdr.height != expected_height:
        raise BlockValidationError(
            f"wrong height {hdr.height}, want {expected_height}"
        )
    if hdr.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong last_block_id")
    if hdr.app_hash != state.app_hash:
        raise BlockValidationError(
            f"wrong app_hash {hdr.app_hash.hex()}, want {state.app_hash.hex()}"
        )
    if hdr.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong last_results_hash")
    if hdr.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong validators_hash")
    if hdr.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong next_validators_hash")
    if hdr.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong consensus_hash")

    # LastCommit: height-1 carries +2/3 of the PREVIOUS validator set.
    if hdr.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.size() != 0:
            raise BlockValidationError(
                "initial block cannot carry a last commit"
            )
    else:
        if block.last_commit is None:
            raise BlockValidationError("missing last commit")
        if block.last_commit.size() != len(state.last_validators):
            raise BlockValidationError(
                f"last commit has {block.last_commit.size()} sigs, "
                f"want {len(state.last_validators)}"
            )
        try:
            tv.verify_commit(
                state.chain_id,
                state.last_validators,
                state.last_block_id,
                hdr.height - 1,
                block.last_commit,
                device=device,
            )  # the hot batch: types/validation.go:26 -> K2
        except tv.VerificationError as e:
            raise BlockValidationError(f"invalid last commit: {e}") from e

    # Proposer must belong to the current validator set.
    if not state.validators.has_address(hdr.proposer_address):
        raise BlockValidationError("proposer not in validator set")

    # Block time sanity: must advance past the previous block
    # (median-time checks live with the consensus FSM's proposal rules).
    if hdr.height > state.initial_height and (
        hdr.time_ns <= state.last_block_time_ns
    ):
        raise BlockValidationError("block time must be monotonically increasing")
