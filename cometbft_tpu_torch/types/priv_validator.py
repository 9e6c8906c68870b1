"""PrivValidator interface + in-memory mock (reference: types/priv_validator.go).

The production FilePV (double-sign protection, key files) belongs to
``privval/``, which is not ported yet; MockPV is the deterministic signer
of the consensus fixtures (common_test.go's validatorStub).
"""

from __future__ import annotations

from ..crypto.keys import Ed25519PrivKey
from . import canonical
from .vote import Proposal, Vote


class PrivValidator:
    """SignVote/SignProposal contract (types/priv_validator.go:18-27)."""

    def get_pub_key(self):
        raise NotImplementedError

    def sign_vote(
        self, chain_id: str, vote: Vote, sign_extension: bool
    ) -> None:
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise NotImplementedError


class MockPV(PrivValidator):
    """Deterministic in-memory signer (types/priv_validator.go:73-135)."""

    def __init__(
        self,
        priv_key: Ed25519PrivKey | None = None,
        break_proposal_sigs: bool = False,
        break_vote_sigs: bool = False,
    ):
        self.priv_key = priv_key or Ed25519PrivKey.generate()
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(
        self, chain_id: str, vote: Vote, sign_extension: bool = True
    ) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_vote_sigs else chain_id
        vote.signature = self.priv_key.sign(vote.sign_bytes(use_chain_id))
        if (
            sign_extension
            and vote.msg_type == canonical.PRECOMMIT_TYPE
            and not vote.block_id.is_nil()
        ):
            vote.extension_signature = self.priv_key.sign(
                vote.extension_sign_bytes(use_chain_id)
            )

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        use_chain_id = (
            "incorrect-chain-id" if self.break_proposal_sigs else chain_id
        )
        proposal.signature = self.priv_key.sign(
            proposal.sign_bytes(use_chain_id)
        )


class ErroringMockPV(MockPV):
    """Always refuses to sign (types/priv_validator.go:139-158)."""

    def sign_vote(self, chain_id, vote, sign_extension=True):
        raise RuntimeError("erroring mock private validator")

    def sign_proposal(self, chain_id, proposal):
        raise RuntimeError("erroring mock private validator")
