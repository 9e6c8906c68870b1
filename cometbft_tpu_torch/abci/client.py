"""ABCI client abstraction (reference: abci/client/client.go:24,
abci/client/local_client.go:186).

``Client`` = Service + the Application method set + an async CheckTx path
with callbacks (the only method the reference calls asynchronously —
mempool ingress). ``ReqRes`` carries one in-flight request; its callback
fires when the response lands. ``LocalClient`` runs an in-process app
behind one mutex — the default for a single-binary node.
"""

from __future__ import annotations

import threading
from ..libs import sync as libsync
from typing import Callable

from ..libs.service import BaseService
from . import types as abci
from .application import Application


class ReqRes:
    """One request/response pair; ``wait()`` blocks until the response."""

    def __init__(self, method: str, request):
        self.method = method
        self.request = request
        self.response = None
        self.error: Exception | None = None
        self._done = threading.Event()
        self._cb: Callable | None = None
        self._mtx = libsync.Mutex("abci.client._mtx")

    def set_callback(self, cb: Callable) -> None:
        """Fires on successful completion only; error completions surface
        through ``wait()`` / the client's error callback instead."""
        with self._mtx:
            if self._done.is_set():
                done = self.error is None
            else:
                self._cb = cb
                done = False
        if done:
            cb(self.response)

    def _complete(self, response) -> None:
        with self._mtx:
            self.response = response
            cb = self._cb
            self._done.set()
        if cb:
            cb(response)

    def _complete_error(self, err: Exception) -> None:
        with self._mtx:
            self.error = err
            self._done.set()

    def wait(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"ABCI {self.method} timed out")
        if self.error is not None:
            raise self.error
        return self.response


class SpeculationUnsupported(Exception):
    """The client/app pair cannot run speculative finalization.

    Raised by ``Client.speculate_finalize`` when the transport is remote
    (socket/grpc — no way to isolate the app) or the application does
    not implement the optional ``snapshot_spec_state`` /
    ``restore_spec_state`` extension. Callers fall back to the serial
    FinalizeBlock path; the error carries no app-state consequences.
    """


class Client(BaseService):
    """Service + Application surface + async CheckTx + global callback."""

    def __init__(self, name: str = "abci-client"):
        super().__init__(name)
        self._global_cb: Callable | None = None
        self._err: Exception | None = None
        self._on_error: Callable[[Exception], None] | None = None

    def set_response_callback(self, cb: Callable) -> None:
        """Global callback fired for every async response (mempool uses
        this to learn CheckTx results — clist_mempool.go:373)."""
        self._global_cb = cb

    def set_error_callback(self, cb: Callable[[Exception], None]) -> None:
        """Fired once on unrecoverable transport failure; the proxy layer
        uses it to fail-stop the node (multi_app_conn.go:129)."""
        self._on_error = cb

    def error(self) -> Exception | None:
        return self._err

    # sync surface (consensus/query/snapshot connections)
    def echo(self, msg: str) -> str:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    def check_tx_async(self, req: abci.RequestCheckTx) -> ReqRes:
        raise NotImplementedError

    def init_chain(self, req) -> abci.ResponseInitChain:
        raise NotImplementedError

    def prepare_proposal(self, req) -> abci.ResponsePrepareProposal:
        raise NotImplementedError

    def process_proposal(self, req) -> abci.ResponseProcessProposal:
        raise NotImplementedError

    def finalize_block(self, req) -> abci.ResponseFinalizeBlock:
        raise NotImplementedError

    def extend_vote(self, req) -> abci.ResponseExtendVote:
        raise NotImplementedError

    def verify_vote_extension(self, req) -> abci.ResponseVerifyVoteExtension:
        raise NotImplementedError

    def commit(self, req=None) -> abci.ResponseCommit:
        raise NotImplementedError

    def list_snapshots(self, req) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(self, req) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(self, req) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError

    # -- optional speculation extension (consensus/pipeline.py) ------------

    def supports_speculation(self) -> bool:
        """Whether speculate_finalize can work at all for this
        client/app pair (node boot keys COMETBFT_TPU_SPEC_EXEC=auto
        off this)."""
        return False

    def speculate_finalize(self, req) -> tuple:
        """Run FinalizeBlock speculatively and leave the app UNCHANGED.

        Returns ``(response, post_token)`` where ``post_token`` is an
        opaque snapshot of the post-finalize app state; a later
        ``apply_speculation(post_token)`` makes the speculative result
        real without re-executing. Only local clients over apps that
        implement the snapshot/restore extension support this — remote
        transports cannot isolate the app, so the base client refuses.
        """
        raise SpeculationUnsupported(f"{self.name}: remote ABCI transport")

    def apply_speculation(self, post_token) -> None:
        raise SpeculationUnsupported(f"{self.name}: remote ABCI transport")


class LocalClient(Client):
    """In-process app behind one mutex (local_client.go:186). The mutex may
    be shared across the 4 proxy connections so consensus/mempool/query
    calls serialize exactly like the reference's ``NewLocalClientCreator``.
    """

    def __init__(self, app: Application, mtx: threading.RLock | None = None):
        super().__init__("local-abci-client")
        self.app = app
        self.mtx = mtx or libsync.RLock("abci.client")

    def echo(self, msg: str) -> str:
        return msg

    def flush(self) -> None:
        pass

    def _call(self, method: str, req):
        with self.mtx:  # cometlint: disable=CLNT009 -- the local-client mutex serializes the app exactly like NewLocalClientCreator; app-side persistence is the call's purpose
            return getattr(self.app, method)(req)

    def info(self, req):
        return self._call("info", req)

    def query(self, req):
        return self._call("query", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def check_tx_async(self, req) -> ReqRes:
        rr = ReqRes("check_tx", req)
        res = self._call("check_tx", req)
        rr._complete(res)
        if self._global_cb:
            self._global_cb(req, res)
        return rr

    def init_chain(self, req):
        return self._call("init_chain", req)

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)

    def finalize_block(self, req):
        return self._call("finalize_block", req)

    def extend_vote(self, req):
        return self._call("extend_vote", req)

    def verify_vote_extension(self, req):
        return self._call("verify_vote_extension", req)

    def commit(self, req=None):
        return self._call("commit", req or abci.RequestCommit())

    def list_snapshots(self, req):
        return self._call("list_snapshots", req)

    def offer_snapshot(self, req):
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self._call("apply_snapshot_chunk", req)

    # -- speculation (consensus/pipeline.py's cs-spec-exec worker) ---------

    def supports_speculation(self) -> bool:
        return callable(
            getattr(self.app, "snapshot_spec_state", None)
        ) and callable(getattr(self.app, "restore_spec_state", None))

    def speculate_finalize(self, req) -> tuple:
        """FinalizeBlock inside a snapshot/restore sandwich, atomic under
        the shared proxy mutex: snapshot pre → finalize → snapshot post →
        restore pre. The app comes out exactly as it went in, so a
        speculation that never wins (different block, round change, node
        restart) needs no cleanup, and concurrent connections never see
        half-speculated state."""
        with self.mtx:  # cometlint: disable=CLNT009 -- the snapshot/finalize/restore sandwich must be atomic against the other proxy connections
            if not self.supports_speculation():
                raise SpeculationUnsupported(
                    f"{type(self.app).__name__} lacks snapshot_spec_state/"
                    "restore_spec_state"
                )
            pre = self.app.snapshot_spec_state()
            try:
                resp = self.app.finalize_block(req)
                post = self.app.snapshot_spec_state()
            finally:
                self.app.restore_spec_state(pre)
            return resp, post

    def apply_speculation(self, post_token) -> None:
        """Make a speculative finalize real: restore the memoized
        post-finalize state so the following Commit persists it."""
        with self.mtx:  # cometlint: disable=CLNT009 -- restoring the memoized post-state must serialize against the other proxy connections
            if not self.supports_speculation():
                raise SpeculationUnsupported(
                    f"{type(self.app).__name__} lacks restore_spec_state"
                )
            self.app.restore_spec_state(post_token)
