"""Evidence verification (reference: evidence/verify.go:19-294).

``device`` (default the GPU) is where a light-client attack's trusting
commit check runs (types/validation, K2 over the pubkey arena); the
two signatures of a duplicate vote verify singly on the host
(crypto/fast25519), as the reference's do.
"""

from __future__ import annotations

from ..types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    LightClientAttackEvidence,
)
from ..types.validation import verify_commit_light_trusting, Fraction


def verify_evidence(ev, state, val_set_at_height, common_val_set=None,
                    *, device="cuda") -> None:
    """evidence/verify.go:19 — age checks then type-specific verification.

    ``val_set_at_height``: validator set at ev.height (from state store).
    """
    height = state.last_block_height
    ev_params = state.consensus_params.evidence
    age_blocks = height - ev.height()
    age_ns = state.last_block_time_ns - ev.time_ns()
    if (
        age_blocks > ev_params.max_age_num_blocks
        and age_ns > ev_params.max_age_duration_ns
    ):
        raise EvidenceError(
            f"evidence from height {ev.height()} is too old "
            f"({age_blocks} blocks / {age_ns / 1e9:.0f}s)"
        )
    from ..libs import devledger

    # outermost ledger tenant: every routed verify under evidence
    # checking (vote signatures, the attack header's trusting commit
    # check) attributes to the evidence caller class
    with devledger.caller_class("evidence"):
        if isinstance(ev, DuplicateVoteEvidence):
            verify_duplicate_vote(ev, state.chain_id, val_set_at_height)
        elif isinstance(ev, LightClientAttackEvidence):
            verify_light_client_attack(
                ev, state.chain_id, common_val_set or val_set_at_height,
                device=device,
            )
        else:
            raise EvidenceError(
                f"unknown evidence type {type(ev).__name__}"
            )


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence, chain_id: str, val_set
) -> None:
    """evidence/verify.go:167 VerifyDuplicateVote — 2 signature checks."""
    _, val = val_set.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise EvidenceError(
            f"address {ev.vote_a.validator_address.hex()} was not a "
            "validator at the evidence height"
        )
    # NOTE: no vote-TYPE restriction — the reference punishes PREVOTE
    # equivocation too (VerifyDuplicateVote:174-181 only requires equal
    # H/R/Type and differing block IDs). A precommit-only rule here once
    # made a proposer pack prevote-equivocation evidence its own block
    # validation then rejected — fatal at finalize (the evidence pool
    # and this verifier must accept the same set).
    ev.validate_basic()
    # recorded powers must match the set we verified against
    if ev.validator_power != val.voting_power:
        raise EvidenceError(
            f"validator power mismatch: {ev.validator_power} vs "
            f"{val.voting_power}"
        )
    if ev.total_voting_power != val_set.total_voting_power():
        raise EvidenceError("total voting power mismatch")
    for vote in (ev.vote_a, ev.vote_b):
        if not val.pub_key.verify_signature(
            vote.sign_bytes(chain_id), vote.signature
        ):
            raise EvidenceError("invalid signature on duplicate vote")


def verify_light_client_attack(
    ev: LightClientAttackEvidence, chain_id: str, common_val_set,
    *, device="cuda",
) -> None:
    """evidence/verify.go:110 — the conflicting header must carry a
    commit trusted at 1/3 of the common validator set (the batched
    light-trusting path)."""
    ev.validate_basic()
    sh = ev.conflicting_block.signed_header
    verify_commit_light_trusting(
        chain_id, common_val_set, sh.commit, Fraction(1, 3), device=device
    )
