"""The 14-method Application interface (reference:
abci/types/application.go:9-35) and a no-op base implementation
(``BaseApplication``, abci/types/application.go:43+) that concrete apps
override selectively.
"""

from __future__ import annotations

from . import types as abci


class Application:
    """ABCI 2.0: Info/Query, mempool, consensus, and snapshot groups."""

    # Info/Query connection
    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    # Mempool connection
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    # Consensus connection
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def prepare_proposal(
        self, req: abci.RequestPrepareProposal
    ) -> abci.ResponsePrepareProposal:
        raise NotImplementedError

    def process_proposal(
        self, req: abci.RequestProcessProposal
    ) -> abci.ResponseProcessProposal:
        raise NotImplementedError

    def finalize_block(
        self, req: abci.RequestFinalizeBlock
    ) -> abci.ResponseFinalizeBlock:
        raise NotImplementedError

    def extend_vote(self, req: abci.RequestExtendVote) -> abci.ResponseExtendVote:
        raise NotImplementedError

    def verify_vote_extension(
        self, req: abci.RequestVerifyVoteExtension
    ) -> abci.ResponseVerifyVoteExtension:
        raise NotImplementedError

    def commit(self, req: abci.RequestCommit) -> abci.ResponseCommit:
        raise NotImplementedError

    # State-sync connection
    def list_snapshots(
        self, req: abci.RequestListSnapshots
    ) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError

    # -- optional speculation extension ------------------------------------
    #
    # Apps that want optimistic block execution (consensus/pipeline.py)
    # implement BOTH of these; a local client then runs FinalizeBlock in
    # a snapshot/finalize/restore sandwich so a speculation that never
    # commits leaves no trace. The token is opaque to the engine. An app
    # must only advertise the pair if a restore really reverts EVERY
    # side effect its finalize_block has (in particular: no durable
    # writes inside finalize — persistence belongs in Commit). There is
    # deliberately NO default implementation: a no-op inherited pair on
    # a stateful subclass would silently corrupt it.
    #
    # def snapshot_spec_state(self): ...
    # def restore_spec_state(self, token): ...


class BaseApplication(Application):
    """Accept-everything defaults; concrete apps override what they need."""

    def info(self, req):
        return abci.ResponseInfo()

    def query(self, req):
        return abci.ResponseQuery(code=abci.OK)

    def check_tx(self, req):
        return abci.ResponseCheckTx(code=abci.OK)

    def init_chain(self, req):
        return abci.ResponseInitChain()

    def prepare_proposal(self, req):
        # Default: include txs up to the byte budget (application.go defaults)
        txs, total = [], 0
        for tx in req.txs:
            if req.max_tx_bytes >= 0 and total + len(tx) > req.max_tx_bytes:
                break
            txs.append(tx)
            total += len(tx)
        return abci.ResponsePrepareProposal(txs=txs)

    def process_proposal(self, req):
        return abci.ResponseProcessProposal(
            status=abci.ProcessProposalStatus.ACCEPT
        )

    def finalize_block(self, req):
        return abci.ResponseFinalizeBlock(
            tx_results=[abci.ExecTxResult() for _ in req.txs]
        )

    def extend_vote(self, req):
        return abci.ResponseExtendVote()

    def verify_vote_extension(self, req):
        return abci.ResponseVerifyVoteExtension(
            status=abci.VerifyVoteExtensionStatus.ACCEPT
        )

    def commit(self, req):
        return abci.ResponseCommit()

    def list_snapshots(self, req):
        return abci.ResponseListSnapshots()

    def offer_snapshot(self, req):
        return abci.ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req):
        return abci.ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req):
        return abci.ResponseApplySnapshotChunk(
            result=abci.ApplySnapshotChunkResult.ACCEPT
        )
