"""The Tendermint consensus state machine (reference: consensus/state.go).

Single-writer core: one ``_receive_routine`` thread owns ALL round state
(state.go:750) and consumes a merged queue of peer messages, own messages,
and timeouts. Every message is WAL-logged before processing; own messages
are fsynced so a crash cannot double-sign (state.go:797-805).

Step functions mirror the reference: ``enter_new_round:1018``,
``enter_propose:1105``, ``enter_prevote`` (defaultDoPrevote:1313),
``enter_precommit:1489``, ``enter_commit:1624``, ``try_finalize_commit:1687``,
``finalize_commit:1715``; vote ingest ``try_add_vote:2086``/``add_vote:2137``;
own-vote signing ``sign_vote:2355``/``sign_add_vote:2426``.

``device`` (default the GPU; raises without one) is resolved at
construction and is where the node verifies: the receive loop's
preverify batches (K2 windows, or the pushed coalescer's), each vote
set's batches, the rebuilt last commit and the validator-set prestage
(X1). The proposal's signature goes through the pushed verify
coalescer, if any (crypto/coalesce.verify_signature).

No fallback: where the JAX package swallows an error of the device path
and lets the host verify instead (the preverify catch-all, the
per-message catch-all, the prestage warm-up), the port fail-stops the
node through ``on_fatal``. What counts as the device path's error is
decided where it leaves the verify and hash planes, which mark it
(libs/devicefault), not by its type here: any other error, whatever a
peer's message can cause (a bad vote, part or block, a proposal whose
parts do not decode), is logged and dropped as in the reference, and a
key type with no batch backend still skips preverification.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading

from ..libs import sync as libsync
import time

from ..config import ConsensusConfig
from ..crypto import batch as crypto_batch
from ..libs import devicefault
from ..libs import health as libhealth
from ..libs import metrics as libmetrics
from ..libs import trace as libtrace
from ..libs.events import EventSwitch
from ..libs.service import BaseService
from ..ops import verify as ov
from ..types import BlockID, PartSet, canonical
from ..types.block import Block
from ..types.event_bus import (
    EventDataCompleteProposal,
    EventDataNewRound,
    EventDataRoundState,
    EventDataVote,
    NopEventBus,
)
from ..types.part_set import PartSetError
from ..types.vote import Proposal, Vote
from ..types.vote_set import ConflictingVoteError, VoteSet
from ..types import serialization as ser
from .height_vote_set import HeightVoteSet
from .messages import BlockPartMessage, ProposalMessage, VoteMessage
from .round_state import RoundState, RoundStep
from .ticker import TimeoutTicker
from .wal import MsgInfo, NopWAL, TimeoutInfo

# evsw event names the reactor listens on (consensus/events.go)
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"


class ConsensusError(Exception):
    pass


class FatalConsensusError(ConsensusError):
    """A failure inside the commit chain (save → ApplyBlock → advance).

    The reference PANICS here (state.go finalizeCommit): past +2/3
    precommits the node must either fully apply the block or stop —
    continuing with a half-applied height (block saved, state not)
    operates on inconsistent state. Never absorbed by vote-admission
    error handling; propagates to the receive loop, which fail-stops
    the node.
    """


def commit_to_vote_set(chain_id: str, commit, validators,
                       device="cuda") -> VoteSet:
    """Rebuild the precommit VoteSet a commit came from
    (types/block.go CommitToVoteSet / Commit.ToVoteSet:1088)."""
    vs = VoteSet(
        chain_id, commit.height, commit.round, canonical.PRECOMMIT_TYPE,
        validators, device=device,
    )
    from ..types.block import BLOCK_ID_FLAG_ABSENT

    votes = []
    for idx, cs in enumerate(commit.signatures):
        if cs.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            continue
        votes.append(
            Vote(
                msg_type=canonical.PRECOMMIT_TYPE,
                height=commit.height,
                round=commit.round,
                block_id=cs.block_id(commit.block_id),
                timestamp_ns=cs.timestamp_ns,
                validator_address=cs.validator_address,
                validator_index=idx,
                signature=cs.signature,
            )
        )
    oks, errs = vs.add_votes_batch(votes)  # one batched verify (TPU path)
    if not all(oks):
        cause = next((e for e in errs if e is not None), None)
        raise ConsensusError(
            f"failed to reconstruct seen-commit votes: {cause}"
        )
    return vs


def extended_commit_to_vote_set(chain_id: str, ec, validators,
                                device="cuda") -> VoteSet:
    """Rebuild the precommit VoteSet — with vote extensions — from a stored
    ExtendedCommit (types/block.go ToExtendedVoteSet / reference
    votesFromExtendedCommit). Used after restart when extensions are
    enabled so the next proposal's ExtendedCommitInfo isn't empty."""
    vs = VoteSet(
        chain_id, ec.height, ec.round, canonical.PRECOMMIT_TYPE,
        validators, extensions_enabled=True, device=device,
    )
    from ..types.block import BLOCK_ID_FLAG_ABSENT

    votes = []
    for idx, es in enumerate(ec.extended_signatures):
        cs = es.commit_sig
        if cs.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            continue
        votes.append(
            Vote(
                msg_type=canonical.PRECOMMIT_TYPE,
                height=ec.height,
                round=ec.round,
                block_id=cs.block_id(ec.block_id),
                timestamp_ns=cs.timestamp_ns,
                validator_address=cs.validator_address,
                validator_index=idx,
                signature=cs.signature,
                extension=es.extension,
                extension_signature=es.extension_signature,
            )
        )
    oks, errs = vs.add_votes_batch(votes)
    if not all(oks):
        cause = next((e for e in errs if e is not None), None)
        raise ConsensusError(
            f"failed to reconstruct extended-commit votes: {cause}"
        )
    return vs


class ConsensusState(BaseService):
    def __init__(
        self,
        config: ConsensusConfig,
        state,  # sm.State
        block_exec,
        block_store,
        tx_notifier=None,  # mempool (TxsAvailable signal)
        evidence_pool=None,
        event_bus=None,
        wal=None,
        options=None,
        clock=None,
        *,
        device="cuda",
    ):
        ov.resolve_device(device)
        super().__init__("consensus")
        self.device = device
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.tx_notifier = tx_notifier
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus if event_bus is not None else NopEventBus()
        # lockfree: handle is swapped only inside the single-threaded startup replay (under the mutex); steady-state it is an immutable reference and the WAL's own group lock serializes writes
        self.wal = wal if wal is not None else NopWAL()
        self.evsw = EventSwitch()

        self.priv_validator = None
        self.priv_validator_pub_key = None

        self.rs = RoundState()
        self.state = None  # sm.State, set by update_to_state
        # guards rs reads from other threads; libs.sync so the deadlock
        # tier (COMETBFT_TPU_DEADLOCK=1) instruments the consensus mutex
        self._mtx = libsync.RLock("consensus.state")

        # Time source. Every wall/monotonic read the FSM makes goes
        # through this seam so the simnet plane (cometbft_tpu/simnet)
        # can substitute its virtual clock — the determinism guarantee
        # ("same (seed, scenario) => same heights/rounds/events") needs
        # round-0 sleeps, timeouts and commit latencies derived from
        # simulated time, not from however long the host took. A ctor
        # parameter (not a post-hoc setattr) because update_to_state —
        # called below — already stamps _height_started from it.
        self._clock = clock if clock is not None else time
        # True when a simnet scheduler owns this FSM: on_start skips the
        # receive/ticker-forwarder threads and the scheduler pumps the
        # inbox via process_pending() from its scheduler thread.
        self.sim_driven = False
        # flight-ring origin id (libs/health.register_origin) the
        # receive routine declares for its thread; node/node.py sets it
        # to the node-id prefix so ring rows are node-attributed
        self.health_origin = 0

        # merged inbox: ("peer"|"internal"|"timeout", payload)
        self._queue: queue.Queue = queue.Queue(maxsize=1000)
        self.ticker = TimeoutTicker()
        self._n_started = 0
        # lockfree: True only during the single-threaded startup replay, before any routine exists; steady-state constant False
        self.replay_mode = False
        self.do_wal_catchup = True
        self._on_block_committed = []  # test/metrics hooks: f(height)
        # Fail-stop hook for FatalConsensusError (node wires this to a
        # full node stop; None → os._exit, never a silent dead thread).
        self.on_fatal = None
        # Pipelined-heights engine (consensus/pipeline.CommitPipeline):
        # speculative execution + ordered commit-writer + durability
        # barrier. None => the fully serial reference commit chain.
        # lockfree: wired once at node boot before any routine starts; steady-state an immutable reference (the pipeline has its own mutex)
        self.pipeline = None
        # the first exception a validator-set prestage warm-up raised:
        # the FSM thread raises it at its next prestage or at stop()
        self._prestage_error: BaseException | None = None

        # libs/trace spans for the current height/round/step. Manual
        # (begin/end) because the FSM is event-driven — the intervals
        # do not nest lexically. All three are touched only with the
        # state mutex held (FSM thread + init/replay), ended eagerly on
        # each transition; None whenever tracing was off at the last
        # transition.
        self._tr_height = None
        self._tr_round = None
        self._tr_step = None

        # Event-delivery deferral (cometlint CLNT009/CLNT010): while the
        # receive loop is inside its critical section this collects
        # (publish_fn, args) pairs; delivery happens after the mutex is
        # released so subscriber callbacks — the reactor's evsw
        # re-broadcast does peer sends, pubsub touches its own lock —
        # never run while 'consensus.state' is held. None => immediate
        # delivery (replay, init wiring, direct test calls).
        self._pending_events: list | None = None

        # Construction is single-threaded, but update_to_state mutates
        # the same FSM fields the live commit chain does — taking the
        # (reentrant, uncontended) mutex here keeps one machine-checked
        # invariant: every post-construction write to FSM state holds
        # 'consensus.state'. cometlint's guarded-field pass (CLNT011/012)
        # infers guards as the intersection over write sites, so an
        # unlocked wiring-phase write would erase the guard. Event
        # delivery is deferred past the release for the same reason
        # _locked_dispatch defers it: 'consensus.state' must never be
        # held while a subscriber callback runs, and the runtime
        # lock-order sanitizer checks exactly that.
        with self._deferred_events():
            with self._mtx:
                self.update_to_state(state)
                self.reconstruct_last_commit_if_needed(state)

    def add_block_committed_hook(self, fn) -> None:
        self._on_block_committed.append(fn)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    def set_priv_validator(self, pv) -> None:
        with self._mtx:
            self.priv_validator = pv
            if pv is not None:
                self.priv_validator_pub_key = pv.get_pub_key()

    def get_round_state(self) -> RoundState:
        """Shallow snapshot — never the live object (state.go GetRoundState
        returns rs.Copy(); field-by-field mutation would tear readers)."""
        with self._mtx:
            return dataclasses.replace(self.rs)

    def height(self) -> int:
        with self._mtx:
            return self.rs.height

    # -- message entry points (thread-safe) --------------------------------

    def add_vote_from_peer(self, vote: Vote, peer_id: str) -> None:
        self._queue.put(("peer", MsgInfo(VoteMessage(vote), peer_id)))

    def set_proposal_from_peer(self, proposal: Proposal, peer_id: str) -> None:
        self._queue.put(("peer", MsgInfo(ProposalMessage(proposal), peer_id)))

    def add_block_part_from_peer(
        self, height: int, round_: int, part, peer_id: str
    ) -> None:
        self._queue.put(
            ("peer", MsgInfo(BlockPartMessage(height, round_, part), peer_id))
        )

    def _send_internal(self, msg) -> None:
        """Never block the receive thread on its own queue
        (state.go sendInternalMessage's select/default + goroutine)."""
        item = ("internal", MsgInfo(msg, ""))
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            threading.Thread(
                target=self._queue.put, args=(item,), daemon=True
            ).start()

    def handle_txs_available(self) -> None:
        """Mempool signal (state.go:981) — used with create_empty_blocks=False."""
        self._queue.put(("txs_available", None))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def on_start(self) -> None:
        # the flag read holds the mutex for the same reason __init__
        # takes it: the writer (switch_to_consensus, on the blocksync
        # routine) writes it under the mutex, and uniform discipline is
        # what keeps the inferred guard machine-checkable. Replay
        # handlers publish; deferral delivers after release.
        with self._deferred_events():
            # cometlint: disable=CLNT009,CLNT010 -- single-threaded startup: replay I/O and event delivery run before any routine exists to contend for the mutex
            with self._mtx:
                if self.do_wal_catchup and not isinstance(self.wal, NopWAL):
                    self._catchup_replay()
        self.ticker.start()
        if self.sim_driven:
            # the simnet scheduler pumps the inbox (process_pending) and
            # its SimTicker enqueues tocks directly — no threads
            self._schedule_round0()
            return
        threading.Thread(
            target=self._tock_forwarder, name="cs-tock", daemon=True
        ).start()
        # lockfree: start/stop lifecycle handle — written once by the thread that calls start(); on_stop reads it via getattr after the queue handshake
        self._receive_thread = threading.Thread(
            target=self._receive_routine, name="cs-receive", daemon=True
        )
        self._receive_thread.start()
        self._schedule_round0()

    def on_stop(self) -> None:
        if self.ticker.is_running():
            self.ticker.stop()
        self._queue.put(("quit", None))
        # Drain the loop before the WAL can be closed under it. (Skipped
        # when stop() is reached FROM the receive thread — the fail-stop
        # path after FatalConsensusError — joining yourself raises.)
        rt = getattr(self, "_receive_thread", None)
        if rt is not None and rt is not threading.current_thread():
            rt.join(timeout=5)
        # In-flight prestage builds dying mid-device-call at interpreter
        # teardown can abort the process; give each a bounded drain.
        for pt in getattr(self, "_prestage_threads", []):
            pt.join(timeout=2)
        # Drain the commit-writer BEFORE the WAL can be closed under it:
        # pending jobs fsync through self.wal.
        if self.pipeline is not None:
            self.pipeline.stop()
        self.wal.flush_and_sync()
        # close any open trace spans so a stopped node's trace has no
        # dangling intervals
        for attr in ("_tr_step", "_tr_round", "_tr_height"):
            sp = getattr(self, attr, None)
            if sp is not None:
                sp.end()
                setattr(self, attr, None)
        self._raise_prestage_error()

    def _raise_prestage_error(self) -> None:
        """Raise, once, what a finished prestage warm-up raised: a failed
        X1 build or launch must surface on the FSM thread (or at stop),
        never just disappear with its thread."""
        err, self._prestage_error = self._prestage_error, None
        if err is not None:
            raise FatalConsensusError(
                f"validator-set prestage failed: {err!r}"
            ) from err

    def _tock_forwarder(self) -> None:
        while not self.quit_event().is_set():
            try:
                ti = self.ticker.tock_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._queue.put(("timeout", ti))

    def _schedule_round0(self) -> None:
        sleep_s = max(
            0.0, (self.rs.start_time_ns - self._clock.time_ns()) / 1e9
        )
        self._schedule_timeout(
            sleep_s, self.rs.height, 0, RoundStep.NEW_HEIGHT
        )

    def _schedule_timeout(
        self, duration_s: float, height: int, round_: int, step: RoundStep
    ) -> None:
        self.ticker.schedule_timeout(
            TimeoutInfo(duration_s, height, round_, int(step))
        )

    def _propose_timeout(self, round_: int) -> float:
        """Propose timeout, widened while OUR disk is degraded: a
        slow-but-alive WAL eats into every propose window this node
        waits out (the proposer's own fsyncs delay its proposal by the
        same amount), so stretching the window by a few smoothed fsyncs
        — capped at one extra base timeout — turns spun rounds into a
        slower-but-committing chain (consensus/wal.py disk_degraded).

        Never widened for a sim-driven FSM: the EWMA measures WALL
        fsync time, and feeding wall measurements into virtual-time
        timeout scheduling would break the simnet's bit-reproducibility
        (the sim injects slow disks at the message plane instead)."""
        base = self.config.propose_timeout(round_)
        wal = self.wal
        if not self.sim_driven and wal is not None and wal.disk_degraded():
            base += min(base, 4.0 * wal.fsync_ewma_s())
        return base

    # ------------------------------------------------------------------
    # the single-writer loop
    # ------------------------------------------------------------------

    # Max items drained per micro-batch window. Bounds the per-launch batch
    # and keeps timeouts responsive; 1024 covers a full prevote round of a
    # 1000-validator set arriving at once.
    _DRAIN_WINDOW = 1024

    def _receive_routine(self) -> None:
        # this thread owns the FSM: every flight-ring row it records
        # (steps, proposals, votes, commits, fsyncs) belongs to the
        # node that built this state — declare it once so in-process
        # multi-node harnesses decode per-node timelines (0 = default)
        libhealth.set_thread_origin(self.health_origin)
        while True:
            items = [self._queue.get()]
            # Micro-batch window (SURVEY §7(d)): drain whatever is ALREADY
            # queued — no waiting, so rounds never stall — and preverify all
            # drained vote signatures in one batched launch. Items are then
            # processed strictly in arrival order through the unchanged
            # per-vote state machine, which hits the signature memo instead
            # of verifying one-by-one.
            try:
                while len(items) < self._DRAIN_WINDOW:
                    items.append(self._queue.get_nowait())
            except queue.Empty:
                pass
            if self._process_batch(items):
                return

    def process_pending(self, max_batches: int = 64) -> int:
        """Drain queued inbox items WITHOUT blocking — the simnet
        scheduler's pump (one call per scheduler event, on the scheduler
        thread).  Internal messages a batch generates are picked up by
        the next batch in the same call; ``max_batches`` bounds a
        pathological self-feeding loop.  Returns items processed."""
        done = 0
        for _ in range(max_batches):
            items: list = []
            try:
                while len(items) < self._DRAIN_WINDOW:
                    items.append(self._queue.get_nowait())
            except queue.Empty:
                pass
            if not items:
                break
            done += len(items)
            if self._process_batch(items):
                break
        return done

    def _process_batch(self, items: list) -> bool:
        """WAL-log + dispatch one drained batch (the single-writer body
        shared by the receive thread and the simnet pump).  Returns True
        on the quit sentinel."""
        memo = None
        try:
            memo = self._preverify_queued_votes(items)
        except Exception as e:
            # No fallback: the JAX package prints this and lets the votes
            # verify one by one on the host. Here a failed launch, a
            # kernel build error or a passed deadline fail-stops the node.
            if devicefault.is_fault(e):
                return self._fail_stop(
                    FatalConsensusError(
                        f"vote preverification failed: {e!r}"),
                    e,
                )
            if self.replay_mode:
                raise
            import traceback

            traceback.print_exc()
        try:
            for kind, payload in items:
                if kind == "quit":
                    return True
                try:
                    if kind == "peer":
                        self.wal.write(payload)
                    elif kind == "internal":
                        self.wal.write_sync(payload)
                    elif kind == "timeout":
                        self.wal.write(payload)
                    self._locked_dispatch(kind, payload)
                except FatalConsensusError as e:
                    return self._fail_stop(e, e)
                except Exception as e:
                    if devicefault.is_fault(e):
                        # an error of the device path (vote admission, the
                        # proposal's signature, a hash window,
                        # validate_block's commit): fail-stop, never
                        # answered from the host instead
                        return self._fail_stop(
                            FatalConsensusError(
                                f"device path failed: {e!r}"), e
                        )
                    if self.replay_mode:
                        raise
                    import traceback

                    traceback.print_exc()
        finally:
            if memo:
                # Memo entries are scoped to THIS drain window: votes
                # dropped before reaching signature verification (bad
                # rounds, failed pre-checks) must not let peer-
                # controlled entries accumulate for the height.
                memo.clear()
        return False

    def _fail_stop(self, fatal: FatalConsensusError, cause) -> bool:
        """Fail-stop (state.go finalizeCommit panics): the node must not
        keep running on a half-applied height or a failed device path.
        The on_fatal hook (node wiring) stops the whole node; without one,
        kill the process: a dead consensus thread with a live node would
        be the silent wedge this guards against. True ends the loop."""
        import traceback

        traceback.print_exception(cause)
        if fatal is not cause:
            fatal.__cause__ = cause
        if self.on_fatal is not None:
            self.on_fatal(fatal)
            return True
        os._exit(1)

    @contextlib.contextmanager
    def _deferred_events(self):
        """Collect _publish deliveries while the body runs; drain them
        only after it exits. Wrapped around every ``with self._mtx:``
        region that can reach a publish, so subscriber callbacks never
        run while 'consensus.state' is held (the runtime lock-order
        sanitizer observes acquisition edges and checks exactly this).
        Nests: an inner region feeds the buffer already live, and only
        the outermost exit — past every mutex release — delivers."""
        if self._pending_events is not None:
            yield
            return
        pending: list = []
        # lockfree: FSM-owner plane — exactly one thread drives the FSM at any moment (init wiring -> on_start replay -> blocksync switch_to_consensus -> receive routine), and ownership hand-offs carry happens-before edges (Thread.start, the start/stop queue handshake), so the buffer is never installed or drained concurrently
        self._pending_events = pending
        try:
            yield
        finally:
            # lockfree: same FSM-owner plane as the install above; the reset runs on the same thread that installed the buffer
            self._pending_events = None
            for fn, args in pending:
                try:
                    fn(*args)
                except Exception:
                    # a dead subscriber must not take down the FSM loop;
                    # the traceback still reaches the logs
                    import traceback

                    traceback.print_exc()

    def _locked_dispatch(self, kind: str, payload) -> None:
        """One FSM step under the state mutex, with event delivery
        deferred to AFTER release.

        Holding 'consensus.state' across subscriber callbacks is exactly
        the blocking-under-lock regime the lock-order pass flags: the
        reactor's evsw listener re-broadcasts round steps to every peer
        (socket sends) and the pubsub bus takes its own mutex. Events
        are *constructed* eagerly at the publish site (the payload is a
        snapshot), only delivery moves out of the critical section, so
        RPC/reactor observers see the same data marginally later —
        ordering among events is preserved.
        """
        with self._deferred_events():
            with self._mtx:
                libsync.lockset_note("ConsensusState.state")
                if kind == "timeout":
                    self._handle_timeout(payload)
                elif kind == "txs_available":
                    self._handle_txs_available()
                else:
                    self._handle_msg(payload)

    def _publish(self, fn, *args) -> None:
        """Route one event through the deferral buffer (or deliver
        immediately outside the receive loop — replay, init, tests)."""
        if self._pending_events is not None:
            self._pending_events.append((fn, args))
        else:
            fn(*args)

    def _preverify_queued_votes(self, items) -> dict | None:
        """One batched signature launch for all drained current-height votes.

        Results land in the HeightVoteSet's signature memo keyed by the
        exact (pubkey, sign bytes, signature) triple; admission later pops
        them. Mirrors vote_set.go:216-231's per-vote verify with the
        device-batched layout of SURVEY §7(d). Never changes consensus
        state: a vote with no memo entry (another height, a key type with
        no batch backend) is verified at admission. An exception from the
        verify call itself propagates, and the receive loop fail-stops.
        """
        from ..crypto import coalesce as crypto_coalesce

        votes: list[Vote] = []
        for kind, payload in items:
            if kind == "peer" and isinstance(payload.msg, VoteMessage):
                votes.append(payload.msg.vote)
        # A lone drained vote is worth pre-verifying only when a
        # coalescer is routed: the batch verifier then submits it as a
        # coalescer lane that merges with concurrent callers' windows
        # (the whole point of the steady-state path); without one, a
        # single-lane "batch" is just the per-vote host verify done
        # earlier, so skip straight to admission.
        min_lanes = 1 if crypto_coalesce.active() is not None else 2
        if len(votes) < min_lanes:
            return None
        with self._mtx:
            rs = self.rs
            height = rs.height
            val_set = rs.validators
            memo = rs.votes.sig_memo
            chain_id = self.state.chain_id
        triples: list[tuple] = []
        for vote in votes:
            if vote.height != height:
                continue
            val = val_set.get_by_index(vote.validator_index)
            if val is None:
                continue
            try:
                lanes = [(val.pub_key, vote.sign_bytes(chain_id),
                          vote.signature)]
                if (
                    rs.votes.extensions_enabled
                    and vote.msg_type == canonical.PRECOMMIT_TYPE
                    and not vote.block_id.is_nil()
                    and vote.extension_signature
                ):
                    lanes.append(
                        (
                            val.pub_key,
                            vote.extension_sign_bytes(chain_id),
                            vote.extension_signature,
                        )
                    )
            except Exception:
                # a malformed peer vote: admission rejects it
                continue
            triples.extend(lanes)
        if len(triples) < min_lanes:
            return None
        from ..libs import devledger

        try:
            # Keyed off the SET: a heterogeneous ed25519+sr25519 valset
            # pre-verifies through MixedBatchVerifier (one launch)
            # instead of losing batching to a foreign-key TypeError.
            verifier = crypto_batch.create_commit_batch_verifier(
                val_set, device=self.device
            )
            for pub_key, sign_bytes, sig in triples:
                verifier.add(pub_key, sign_bytes, sig)
        except (ValueError, TypeError):
            # no batch backend for some key type (e.g. secp256k1):
            # skip pre-verification; admission verifies each vote
            return None
        with devledger.caller_class("consensus-vote"):
            _, bits = verifier.verify()
        for (pub_key, sign_bytes, sig), ok in zip(triples, bits):
            memo[(pub_key.bytes(), sign_bytes, sig)] = bool(ok)
        if libtrace.enabled():
            libtrace.event(
                "consensus.preverify",
                height=height,
                lanes=len(triples),
                ok=sum(1 for b in bits if b),
            )
        return memo

    def _handle_msg(self, mi: MsgInfo) -> None:
        msg, peer_id = mi.msg, mi.peer_id
        if isinstance(msg, ProposalMessage):
            try:
                self._set_proposal(msg.proposal)
            except ConsensusError:
                libmetrics.node_metrics().proposals.labels("rejected").inc()
                libhealth.record(
                    libhealth.EV_PROPOSAL,
                    msg.proposal.height, msg.proposal.round, 0,
                )
                raise
        elif isinstance(msg, BlockPartMessage):
            self._add_proposal_block_part(msg, peer_id)
        elif isinstance(msg, VoteMessage):
            self._try_add_vote(msg.vote, peer_id)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < int(rs.step)
        ):
            return  # stale
        step = RoundStep(ti.step)
        if step == RoundStep.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif step == RoundStep.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif step == RoundStep.PROPOSE:
            self._publish(
                self.event_bus.publish_timeout_propose,
                EventDataRoundState(**rs.event_fields()),
            )
            self._enter_prevote(ti.height, ti.round)
        elif step == RoundStep.PREVOTE_WAIT:
            self._publish(
                self.event_bus.publish_timeout_wait,
                EventDataRoundState(**rs.event_fields()),
            )
            self._enter_precommit(ti.height, ti.round)
        elif step == RoundStep.PRECOMMIT_WAIT:
            self._publish(
                self.event_bus.publish_timeout_wait,
                EventDataRoundState(**rs.event_fields()),
            )
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        elif step == RoundStep.COMMIT:
            # timeout_commit elapsed → next height round 0
            self._enter_new_round(ti.height, 0)

    def _handle_txs_available(self) -> None:
        """state.go:981 handleTxsAvailable — round 0 only."""
        rs = self.rs
        if rs.round != 0:
            return
        if rs.step == RoundStep.NEW_HEIGHT:
            # Still inside the timeout_commit window: arm a NEW_ROUND
            # timeout for when it expires instead of dropping the signal.
            remaining = max(
                0.001, (rs.start_time_ns - self._clock.time_ns()) / 1e9 + 0.001
            )
            self._schedule_timeout(
                remaining, rs.height, 0, RoundStep.NEW_ROUND
            )
        elif rs.step == RoundStep.NEW_ROUND:
            self._enter_propose(rs.height, 0)

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------

    def update_to_state(self, state) -> None:
        """state.go:593 updateToState — prep RoundState for the next height."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and state is not None:
            if rs.height != state.last_block_height:
                raise ConsensusError(
                    f"updateToState at height {rs.height} but state is at "
                    f"{state.last_block_height}"
                )
        if (
            self.state is not None
            and state.last_block_height <= self.state.last_block_height
        ):
            return  # stale state (blocksync overlap)

        # Extract last_commit from this height's precommits.
        last_commit = None
        if rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise ConsensusError("updateToState without +2/3 precommits")
            last_commit = precommits

        height = (
            state.initial_height
            if state.last_block_height == 0
            else state.last_block_height + 1
        )

        rs.height = height
        # flight-recorder anchor for the per-height commit-latency SLI
        self._height_started = self._clock.monotonic()
        if libtrace.enabled():
            for attr in ("_tr_step", "_tr_round", "_tr_height"):
                sp = getattr(self, attr, None)
                if sp is not None:
                    sp.end()
            self._tr_round = self._tr_step = None
            self._tr_height = libtrace.begin("consensus.height",
                                             height=height)
        else:
            # see _set_step: no stale spans across a disabled window
            self._tr_height = self._tr_round = self._tr_step = None
        if rs.commit_time_ns == 0:
            rs.start_time_ns = (
                state.last_block_time_ns
                + int(self.config.commit_timeout() * 1e9)
            )
        else:
            rs.start_time_ns = rs.commit_time_ns + int(
                self.config.commit_timeout() * 1e9
            )
        rs.round = 0
        self._set_step(rs, RoundStep.NEW_HEIGHT)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(
            state.chain_id,
            height,
            state.validators,
            extensions_enabled=state.consensus_params.vote_extensions_enabled(
                height
            ),
            device=self.device,
        )
        rs.commit_round = -1
        rs.last_commit = last_commit
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state
        self._new_step()

    def reconstruct_last_commit_if_needed(self, state) -> None:
        """After restart: rebuild rs.last_commit (state.go
        reconstructLastCommit). When vote extensions were enabled at the
        last height, reconstruct from the stored ExtendedCommit so the next
        proposal's ExtendedCommitInfo carries the extensions (reference
        votesFromExtendedCommit); otherwise from the plain seen commit."""
        if state.last_block_height == 0 or self.rs.last_commit is not None:
            return
        if self.block_store is None:
            return
        if state.consensus_params.vote_extensions_enabled(
            state.last_block_height
        ):
            ec = self.block_store.load_block_extended_commit(
                state.last_block_height
            )
            if ec is None:
                raise ConsensusError(
                    "vote extensions enabled but no extended commit stored "
                    f"for height {state.last_block_height}"
                )
            self.rs.last_commit = extended_commit_to_vote_set(
                state.chain_id, ec, state.last_validators, device=self.device
            )
            return
        seen = self.block_store.load_seen_commit()
        if seen is None or seen.height != state.last_block_height:
            return
        self.rs.last_commit = commit_to_vote_set(
            state.chain_id, seen, state.last_validators, device=self.device
        )

    def _new_step(self) -> None:
        rs = self.rs
        ev = EventDataRoundState(**rs.event_fields())
        self._publish(self.event_bus.publish_new_round_step, ev)
        # shallow snapshot: delivery is deferred past further FSM
        # mutations of rs, and the reactor must broadcast the step
        # that PUBLISHED the event, not whatever rs ends up at
        self._publish(
            self.evsw.fire_event, EVENT_NEW_ROUND_STEP,
            dataclasses.replace(rs),
        )

    # -- NewRound (state.go:1018) ------------------------------------------

    def _set_step(self, rs, step) -> None:
        """Step transition + per-step timing
        (consensus/metrics.go StepDurationSeconds)."""
        now = self._clock.monotonic()
        started = getattr(self, "_step_started", None)
        if started is not None:
            libmetrics.node_metrics().step_duration.labels(
                rs.step.name
            ).observe(now - started)
        self._step_started = now
        if libtrace.enabled():
            sp = getattr(self, "_tr_step", None)
            if sp is not None:
                sp.end()
            self._tr_step = libtrace.begin(
                "consensus.step",
                parent=getattr(self, "_tr_round", None),
                height=rs.height,
                round=rs.round,
                step=step.name,
            )
        else:
            # tracing turned off mid-run: drop the stale span so a
            # later re-enable doesn't end it with a duration covering
            # the whole disabled window
            self._tr_step = None
        rs.step = step
        # always-on flight recorder: the stall watchdog keys off this
        # transition's timestamp (libs/health; allocation- and lock-free)
        libhealth.record(
            libhealth.EV_STEP, rs.height, rs.round, int(step)
        )

    def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            return
        m = libmetrics.node_metrics()
        now_mono = self._clock.monotonic()
        if getattr(self, "_round_started", None) is not None:
            m.round_duration.observe(now_mono - self._round_started)
        self._round_started = now_mono
        m.rounds.set(round_)
        if libtrace.enabled():
            sp = getattr(self, "_tr_round", None)
            if sp is not None:
                sp.end()
            self._tr_round = libtrace.begin(
                "consensus.round",
                parent=getattr(self, "_tr_height", None),
                height=height,
                round=round_,
            )
        else:
            self._tr_round = None  # see _set_step: no stale spans
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy_increment_proposer_priority(
                round_ - rs.round
            )
        rs.round = round_
        self._set_step(rs, RoundStep.NEW_ROUND)
        rs.validators = validators
        if round_ != 0:
            # round 0 keeps proposal from NEW_HEIGHT reset
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.triggered_timeout_precommit = False
        rs.votes.set_round(round_ + 1)
        # Pre-stage the validator set's expanded-pubkey tables device-side
        # so this round's vote/commit verifies ship only R|S|k (zero
        # builder launches in steady state). Fingerprinted by valset hash:
        # rounds without churn are a dict no-op.
        # Off the FSM thread: on accelerator backends a valset change
        # costs a full builder device round trip, which must not delay
        # publish_new_round. Tables are a pure function of the key and
        # the cache is thread-safe, so a racing verify at worst builds
        # the same tables itself. A warm-up that raised is raised here,
        # at the next prestage (the JAX package lets the thread die).
        self._raise_prestage_error()
        vhash = validators.hash()
        if vhash != getattr(self, "_prestaged_valset", None) and vhash != getattr(
            self, "_prestage_inflight", None
        ):
            # Mark staged only when the warm-up RETURNS (a thread that
            # dies must not permanently skip this valset); the inflight
            # marker stops churn rounds spawning duplicate warm-ups.
            # Both attributes are touched only on the FSM thread except
            # the success store, which is idempotent.
            # lockfree: FSM-thread-only writes plus an idempotent clear from the warm-up thread; a stale read only costs one duplicate (cached) prestage
            self._prestage_inflight = vhash

            def _warm(vs=validators, h=vhash):
                try:
                    crypto_batch.prestage_validators(vs, device=self.device)
                    self._prestaged_valset = h
                except BaseException as e:  # noqa: BLE001 - raised on the FSM thread
                    if self._prestage_error is None:
                        self._prestage_error = e
                finally:
                    # only clear OUR marker: a newer valset's warm-up may
                    # have replaced it while we ran
                    if getattr(self, "_prestage_inflight", None) == h:
                        self._prestage_inflight = None

            threads = [
                t
                for t in getattr(self, "_prestage_threads", [])
                if t.is_alive()
            ]
            t = threading.Thread(
                target=_warm, name="prestage-valset", daemon=True
            )
            t.start()
            threads.append(t)
            self._prestage_threads = threads
        self._publish(
            self.event_bus.publish_new_round,
            EventDataNewRound(
                height=height,
                round=round_,
                step=rs.step.short,
                proposer_address=validators.get_proposer().address,
            )
        )
        wait_for_txs = (
            not self.config.create_empty_blocks and round_ == 0
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval_ns > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval_ns / 1e9,
                    height, round_, RoundStep.NEW_ROUND,
                )
            # else wait for handle_txs_available
        else:
            self._enter_propose(height, round_)

    # -- Propose (state.go:1105) -------------------------------------------

    def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        rs.round = round_
        self._set_step(rs, RoundStep.PROPOSE)
        self._new_step()
        self._schedule_timeout(
            self._propose_timeout(round_), height, round_,
            RoundStep.PROPOSE,
        )
        if self.priv_validator is None or self.priv_validator_pub_key is None:
            # Not a validator — just wait for the proposal.
            if rs.proposal_complete():
                self._enter_prevote(height, round_)
            return
        addr = bytes(self.priv_validator_pub_key.address())
        if not rs.validators.has_address(addr):
            if rs.proposal_complete():
                self._enter_prevote(height, round_)
            return
        if rs.validators.get_proposer().address == addr:
            self._decide_proposal(height, round_)
        if rs.proposal_complete():
            self._enter_prevote(height, round_)

    def _wait_pipeline_durable(self, height: int) -> None:
        """The durability barrier (docs/perf.md "Pipelined heights"):
        block until every height <= ``height`` is fsynced + applied by
        the commit-writer.  The FSM may PROCESS H+1 messages while H's
        durable suffix drains, but it must not SIGN for H+1 (a crash
        would forget votes the network already saw — double-sign risk)
        nor feed the app H+1 proposals before Commit(H) landed.  Called
        holding 'consensus.state' by design — not advancing is the
        point; the writer never takes the FSM mutex, so this cannot
        deadlock, and the wait is bounded (a wedged writer fail-stops
        the node, same as any commit-chain failure)."""
        pipe = self.pipeline
        if (
            pipe is None
            or not pipe.enabled
            or self.replay_mode
            or height <= 0
        ):
            return
        try:
            pipe.wait_durable(height)
        except Exception as e:
            raise FatalConsensusError(
                f"durability barrier failed waiting for height "
                f"{height}: {e!r}"
            ) from e

    def _decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1244 defaultDecideProposal."""
        # barrier: the proposal for H reaps the mempool and builds on
        # state(H-1) — both must reflect a durable H-1
        self._wait_pipeline_durable(height - 1)
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            block = self._create_proposal_block(height)
            if block is None:
                return
            parts = PartSet.from_data(ser.dumps(block))
        block_id = BlockID(block.hash(), parts.header)
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=block_id,
            timestamp_ns=self._clock.time_ns(),
        )
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception:
            # Expected during WAL replay: FilePV refuses to re-sign an
            # already-signed HRS with different data (state.go:1217 logs
            # only outside replay mode).
            return
        self._send_internal(ProposalMessage(proposal))
        for i in range(parts.header.total):
            self._send_internal(
                BlockPartMessage(height, round_, parts.get_part(i))
            )

    def _create_proposal_block(self, height: int) -> Block | None:
        rs = self.rs
        if height == self.state.initial_height:
            last_ext_commit = None
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            last_ext_commit = rs.last_commit.make_extended_commit()
        else:
            return None  # don't have the commit for the last block
        proposer = bytes(self.priv_validator_pub_key.address())
        return self.block_exec.create_proposal_block(
            height, self.state, last_ext_commit, proposer,
            time_ns=self._clock.time_ns(),
        )

    # -- proposal ingest ---------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """state.go setProposal / defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
            proposal.pol_round >= 0 and proposal.pol_round >= proposal.round
        ):
            raise ConsensusError("invalid POL round in proposal")
        proposer = rs.validators.get_proposer()
        sign_bytes = proposal.sign_bytes(self.state.chain_id)
        # Routed through the cross-caller coalescer when one is active:
        # the proposal check then shares a device micro-batch with the
        # votes draining around it (identical verdict). Unlike the JAX
        # package's, the port's coalescer has no host fallback: a failed
        # window raises (crypto/coalesce.verify_signature), and the
        # receive loop fail-stops. Unrouted, the host verifies it, as in
        # the reference.
        from ..crypto import coalesce as crypto_coalesce
        from ..libs import devledger

        with devledger.caller_class("proposal"):
            sig_ok = crypto_coalesce.verify_signature(
                proposer.pub_key, sign_bytes, proposal.signature
            )
        if not sig_ok:
            raise ConsensusError("invalid proposal signature")
        rs.proposal = proposal
        libmetrics.node_metrics().proposals.labels("accepted").inc()
        libhealth.record(libhealth.EV_PROPOSAL, rs.height, rs.round, 1)
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header
            )

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> None:
        """state.go addProposalBlockPart."""
        rs = self.rs
        if msg.height != rs.height:
            return
        if rs.proposal_block_parts is None:
            return  # no proposal yet; parts are re-gossiped
        try:
            added = rs.proposal_block_parts.add_part(msg.part)
        except PartSetError:
            if peer_id:
                return  # bad peer part; ignore (reactor may punish)
            raise
        if not added:
            return
        self._publish(self.evsw.fire_event, EVENT_PROPOSAL_BLOCK_PART, msg)
        if not rs.proposal_block_parts.is_complete():
            return
        block = ser.loads(rs.proposal_block_parts.assemble())
        rs.proposal_block = block
        self._publish(
            self.event_bus.publish_complete_proposal,
            EventDataCompleteProposal(
                height=rs.height,
                round=rs.round,
                step=rs.step.short,
                block_id=BlockID(block.hash(), rs.proposal_block_parts.header),
            )
        )
        prevotes = rs.votes.prevotes(rs.round)
        maj23 = prevotes.two_thirds_majority() if prevotes else None
        if maj23 is not None and not maj23.is_nil() and rs.valid_round < rs.round:
            if block.hash() == maj23.hash:
                rs.valid_round = rs.round
                rs.valid_block = block
                rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= RoundStep.PROPOSE and rs.proposal_complete():
            self._enter_prevote(rs.height, rs.round)
        elif rs.step == RoundStep.COMMIT:
            self._try_finalize_commit(rs.height)

    # -- Prevote (state.go:1264,1313) --------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        rs.round = round_
        self._set_step(rs, RoundStep.PREVOTE)
        self._new_step()
        self._do_prevote(height, round_)

    def _do_prevote(self, height: int, round_: int) -> None:
        """defaultDoPrevote (state.go:1313-1452, 0.39 semantics).

        There is no unlocking: a validator locked on a block prevotes nil for
        anything else unless the proposal carries a POL (Proposal.pol_round)
        at or after its locked round — the algorithm's line-28 rule.  The old
        prevote-the-lock shortcut had documented liveness defects.
        """
        rs = self.rs
        if rs.proposal_block is None or rs.proposal is None:
            self._sign_add_vote(canonical.PREVOTE_TYPE, b"", None)
            return
        # barrier: ProcessProposal below consults the app, which must
        # already hold Commit(H-1) — never show it H's proposal while
        # H-1's commit is still draining on the writer
        self._wait_pipeline_durable(height - 1)
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except Exception as e:
            if devicefault.is_fault(e):
                raise  # a verify or hash failed on the card: fail-stop
            # Invalid from consensus' perspective → prevote nil.
            self._sign_add_vote(canonical.PREVOTE_TYPE, b"", None)
            return

        def prevote_proposal() -> None:
            # Every prevote-the-block path funnels through here, always
            # AFTER validate_block above — start executing it
            # speculatively so a precommit win finds FinalizeBlock
            # already memoized (consensus/pipeline.py).
            pipe = self.pipeline
            if (
                pipe is not None
                and pipe.spec_enabled
                and not self.replay_mode
            ):
                blk, st, be = rs.proposal_block, self.state, self.block_exec
                try:
                    pipe.submit_speculation(
                        height,
                        blk.hash(),
                        lambda: be.speculate_block(st, blk),
                    )
                except Exception as e:
                    # Only the cs-spec-exec CRASH SEAM escapes an inline
                    # submit (real speculation failures are absorbed
                    # inside the pipeline and degrade to a serial
                    # commit) — treat it like any simulated process
                    # death: fail-stop the node.
                    raise FatalConsensusError(
                        f"crash seam in speculative execution: {e!r}"
                    ) from e
            self._sign_add_vote(
                canonical.PREVOTE_TYPE,
                rs.proposal_block.hash(),
                rs.proposal_block_parts.header,
            )

        if rs.proposal.pol_round == -1:
            # Fresh proposal, never had a +2/3 majority (line 22-26).
            if rs.locked_round == -1:
                if (
                    rs.valid_round != -1
                    and rs.valid_block is not None
                    and rs.proposal_block.hash() == rs.valid_block.hash()
                ):
                    # Matches our valid block: app-validity already attested
                    # by a correct node; no ProcessProposal round trip.
                    prevote_proposal()
                    return
                try:
                    accepted = self.block_exec.process_proposal(
                        rs.proposal_block, self.state
                    )
                except Exception as e:
                    if devicefault.is_fault(e):
                        raise
                    accepted = False
                if accepted:
                    prevote_proposal()
                else:
                    self._sign_add_vote(canonical.PREVOTE_TYPE, b"", None)
                return
            if rs.proposal_block.hash() == rs.locked_block.hash():
                prevote_proposal()
                return
            self._sign_add_vote(canonical.PREVOTE_TYPE, b"", None)
            return

        # Re-proposal carrying a POL round (line 28-32): prevote it iff a
        # +2/3 prevote majority for this block exists at pol_round and our
        # lock is not more recent (or matches the block). ProcessProposal is
        # intentionally NOT called here — the +2/3 prevotes at pol_round mean
        # at least one correct node already app-validated it
        # (state.go:1413-1431's "we don't need to query the application").
        pol_prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        maj23 = pol_prevotes.two_thirds_majority() if pol_prevotes else None
        if (
            maj23 is not None
            and not maj23.is_nil()
            and rs.proposal_block.hash() == maj23.hash
            and 0 <= rs.proposal.pol_round < rs.round
        ):
            if rs.locked_round <= rs.proposal.pol_round:
                prevote_proposal()
                return
            if rs.proposal_block.hash() == rs.locked_block.hash():
                prevote_proposal()
                return
        self._sign_add_vote(canonical.PREVOTE_TYPE, b"", None)

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise ConsensusError("enterPrevoteWait without any +2/3 prevotes")
        rs.round = round_
        self._set_step(rs, RoundStep.PREVOTE_WAIT)
        self._new_step()
        self._schedule_timeout(
            self.config.prevote_timeout(round_), height, round_,
            RoundStep.PREVOTE_WAIT,
        )

    # -- Precommit (state.go:1489) -----------------------------------------

    def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        rs.round = round_
        self._set_step(rs, RoundStep.PRECOMMIT)
        self._new_step()
        prevotes = rs.votes.prevotes(round_)
        maj23 = prevotes.two_thirds_majority() if prevotes else None

        if maj23 is None:
            # No polka → precommit nil.
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"", None)
            return

        self._publish(
            self.event_bus.publish_polka,
            EventDataRoundState(**rs.event_fields()),
        )

        pol_round, _ = rs.votes.pol_info()
        if pol_round < round_:
            raise ConsensusError("POL round inconsistent with +2/3 prevotes")

        if maj23.is_nil():
            # +2/3 prevoted nil → precommit nil.  The lock is NOT cleared:
            # 0.39 removed all unlocking (state.go:1534-1539).
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"", None)
            return

        if rs.locked_block is not None and rs.locked_block.hash() == maj23.hash:
            # Relock.
            rs.locked_round = round_
            self._publish(
                self.event_bus.publish_relock,
                EventDataRoundState(**rs.event_fields()),
            )
            self._sign_add_vote(
                canonical.PRECOMMIT_TYPE, maj23.hash, maj23.part_set_header
            )
            return

        if rs.proposal_block is not None and rs.proposal_block.hash() == maj23.hash:
            # Lock the proposal block (validate first — must never lock an
            # invalid block).
            self.block_exec.validate_block(self.state, rs.proposal_block)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._publish(
                self.event_bus.publish_lock,
                EventDataRoundState(**rs.event_fields()),
            )
            self._sign_add_vote(
                canonical.PRECOMMIT_TYPE, maj23.hash, maj23.part_set_header
            )
            return

        # +2/3 prevoted a block we don't have → fetch it and precommit nil,
        # keeping any existing lock (state.go:1580-1589).
        if (
            rs.proposal_block_parts is None
            or rs.proposal_block_parts.header != maj23.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(maj23.part_set_header)
        self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"", None)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise ConsensusError("enterPrecommitWait without +2/3 precommits")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit_timeout(round_), height, round_,
            RoundStep.PRECOMMIT_WAIT,
        )

    # -- Commit (state.go:1624) --------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        precommits = rs.votes.precommits(commit_round)
        maj23 = precommits.two_thirds_majority()
        if maj23 is None or maj23.is_nil():
            raise ConsensusError("enterCommit without +2/3 for a block")
        self._set_step(rs, RoundStep.COMMIT)
        rs.commit_round = commit_round
        rs.commit_time_ns = self._clock.time_ns()
        self._new_step()

        if rs.locked_block is not None and rs.locked_block.hash() == maj23.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or rs.proposal_block.hash() != maj23.hash:
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(maj23.part_set_header)
            self._publish(
                self.evsw.fire_event, EVENT_VALID_BLOCK,
                dataclasses.replace(rs),
            )
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        maj23 = precommits.two_thirds_majority() if precommits else None
        if maj23 is None or maj23.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != maj23.hash:
            return  # still waiting for block parts
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """state.go:1715 — save, apply, advance."""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        try:
            self._finalize_commit_locked(height)
        except FatalConsensusError:
            raise
        except Exception as e:
            raise FatalConsensusError(
                f"failure finalizing height {height}: {e!r}"
            ) from e

    def _finalize_commit_locked(self, height: int) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(rs.commit_round)
        block_id = precommits.two_thirds_majority()
        block, parts = rs.proposal_block, rs.proposal_block_parts
        block.validate_basic()

        from ..libs.fail import fail_point

        # Claim the speculative FinalizeBlock if we executed this exact
        # block at prevote time (records hit/miss/abort either way). A
        # hit skips re-validation: speculation is only ever submitted
        # from _do_prevote AFTER validate_block passed on this block.
        pipe = self.pipeline
        spec = None
        if pipe is not None and not self.replay_mode:
            spec = pipe.consume_speculation(
                height, rs.commit_round, block.hash()
            )
        if spec is None:
            self.block_exec.validate_block(self.state, block)

        pipelined = (
            pipe is not None and pipe.enabled and not self.replay_mode
        )
        if pipelined:
            # Pipelined commit (docs/perf.md "Pipelined heights"): the
            # FSM runs only the in-memory half — FinalizeBlock (or the
            # memoized speculation) and the State(H+1) derivation — and
            # hands the ENTIRE durable suffix to the ordered
            # commit-writer in the exact serial order, so every crash
            # window maps onto the reference recovery matrix and the
            # app is never durably ahead of the block store
            # (consensus/replay.py's handshake invariant).  The FSM
            # then advances to H+1 immediately; _wait_pipeline_durable
            # fences signing until this job completes.  WAL note: H+1
            # peer/timeout records may land BEFORE the worker's
            # EndHeight(H) marker and so are invisible to replay —
            # harmless, they are re-gossiped/re-armed; own messages
            # cannot, because signing waits on the barrier.
            spec_resp, spec_post = spec if spec is not None else (None, None)
            new_state, resp = self.block_exec.begin_apply(
                self.state, block_id, block, spec_resp=spec_resp
            )
            extended = self.state.consensus_params.vote_extensions_enabled(
                height
            )
            seen_commit = None if extended else precommits.make_commit()
            ext_commit = (
                precommits.make_extended_commit(True) if extended else None
            )
            store, wal, block_exec = self.block_store, self.wal, self.block_exec

            def _durable_suffix():
                fail_point("cs-pipeline-save")
                fail_point("cs-before-save-block")
                if store.height() < block.header.height:
                    if ext_commit is not None:
                        store.save_block_with_extended_commit(
                            block, parts, ext_commit
                        )
                    else:
                        store.save_block(block, parts, seen_commit)
                fail_point("cs-after-save-block")
                # crash window between the durable block and its fsynced
                # EndHeight marker — recovered by the handshake replay
                # of the stored-but-unapplied tip
                fail_point("cs-pipeline-fsync")
                wal.write_end_height(height, overlapped=True)
                fail_point("cs-after-end-height")
                block_exec.complete_apply(
                    new_state, block_id, block, resp, spec_token=spec_post
                )
                fail_point("cs-after-apply-block")

            pipe.enqueue_commit(height, _durable_suffix)
            # warm H+1's device windows while the suffix drains
            pipe.prestage_next(new_state.validators)
        else:
            fail_point("cs-before-save-block")
            if self.block_store.height() < block.header.height:
                seen_commit = precommits.make_commit()
                if self.state.consensus_params.vote_extensions_enabled(height):
                    self.block_store.save_block_with_extended_commit(
                        block, parts, precommits.make_extended_commit(True)
                    )
                else:
                    self.block_store.save_block(block, parts, seen_commit)

            fail_point("cs-after-save-block")
            # EndHeight AFTER the block is saved, BEFORE ApplyBlock: a crash
            # in between recovers via the ABCI handshake replay, not the WAL
            # (state.go:1753-1820 fail points).
            self.wal.write_end_height(height)
            fail_point("cs-after-end-height")

            if spec is None:
                new_state = self.block_exec.apply_block(
                    self.state, block_id, block
                )
            else:
                # serial durable order, speculative execution result:
                # same chain, minus the redundant FinalizeBlock
                spec_resp, spec_post = spec
                t0 = time.perf_counter()
                new_state, resp = self.block_exec.begin_apply(
                    self.state, block_id, block, spec_resp=spec_resp
                )
                self.block_exec.complete_apply(
                    new_state, block_id, block, resp,
                    spec_token=spec_post, t0=t0,
                )
            fail_point("cs-after-apply-block")
            if pipe is not None:
                # a serially-committed height (WAL catchup replay, the
                # pipeline knob off) is durable HERE — advance the mark
                # so the barrier, the prune gate and the lag gauge
                # never wait on a debt the writer was never handed
                pipe.note_base(height)

        # per-height commit latency into the flight recorder (the
        # health engine's commit SLI; commit_round+1 = rounds needed;
        # b = tx count, so timelines and SLIs can correlate commit
        # latency with block fullness)
        libhealth.record(
            libhealth.EV_COMMIT, height, rs.commit_round,
            int(
                (
                    self._clock.monotonic()
                    - getattr(
                        self, "_height_started", self._clock.monotonic()
                    )
                ) * 1e9
            ),
            len(block.data.txs),
        )

        for hook in self._on_block_committed:
            hook(height)

        # Next height.
        rs.commit_time_ns = self._clock.time_ns()
        self.update_to_state(new_state)
        self._schedule_round0()

    # ------------------------------------------------------------------
    # votes
    # ------------------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2086."""
        try:
            return self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            libmetrics.node_metrics().duplicate_votes.inc()
            if (
                self.priv_validator_pub_key is not None
                and vote.validator_address
                == bytes(self.priv_validator_pub_key.address())
            ):
                return False  # our own double-sign?! do not gossip evidence
            if self.evidence_pool is not None:
                self.evidence_pool.report_conflicting_votes(e.new, e.existing)
            return False
        except FatalConsensusError:
            # Commit-chain failure triggered by this vote (enterCommit →
            # finalize → ApplyBlock): NOT a vote-admission error — the
            # node may hold a half-applied block. Propagate; the receive
            # loop fail-stops (reference panics in finalizeCommit).
            raise
        except Exception as e:
            if devicefault.is_fault(e):
                raise  # the vote's verify failed on the device path
            if self.replay_mode:
                raise
            # NOT silent: peer votes may legitimately fail validation, but
            # the traceback must reach the logs.
            import traceback

            if self.logger is not None:
                self.logger.error(
                    "exception adding vote",
                    height=vote.height,
                    round=vote.round,
                    peer=peer_id,
                )
            traceback.print_exc()
            return False

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2137."""
        rs = self.rs

        # Late precommit for the previous height completes rs.last_commit.
        if (
            vote.height + 1 == rs.height
            and vote.msg_type == canonical.PRECOMMIT_TYPE
        ):
            if rs.step != RoundStep.NEW_HEIGHT or rs.last_commit is None:
                return False
            if not rs.last_commit.add_vote(vote):
                return False
            if libtrace.enabled():
                libtrace.event(
                    "consensus.vote",
                    height=vote.height,
                    round=vote.round,
                    type="precommit-late",
                    index=vote.validator_index,
                    peer=peer_id,
                )
            self._publish(self.event_bus.publish_vote, EventDataVote(vote))
            self._publish(self.evsw.fire_event, EVENT_VOTE, vote)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return True

        if vote.height != rs.height:
            if vote.height < rs.height:
                libmetrics.node_metrics().late_votes.labels(
                    "precommit"
                    if vote.msg_type == canonical.PRECOMMIT_TYPE
                    else "prevote"
                ).inc()
            return False

        extensions_enabled = rs.votes.extensions_enabled
        if (
            extensions_enabled
            and vote.msg_type == canonical.PRECOMMIT_TYPE
            and not vote.block_id.is_nil()
            and (
                self.priv_validator_pub_key is None
                or vote.validator_address
                != bytes(self.priv_validator_pub_key.address())
            )
        ):
            # App-level extension check (sig checked in VoteSet).
            val = rs.validators.get_by_index(vote.validator_index)
            if val is None:
                return False
            vote.verify_extension(self.state.chain_id, val.pub_key)
            if not self.block_exec.verify_vote_extension(vote, self.state):
                raise ConsensusError("rejected vote extension")

        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        libhealth.record(
            libhealth.EV_VOTE, vote.height, vote.round,
            vote.msg_type, vote.validator_index,
        )
        if libtrace.enabled():
            libtrace.event(
                "consensus.vote",
                height=vote.height,
                round=vote.round,
                type=(
                    "precommit"
                    if vote.msg_type == canonical.PRECOMMIT_TYPE
                    else "prevote"
                ),
                index=vote.validator_index,
                peer=peer_id,
            )
        self._publish(self.event_bus.publish_vote, EventDataVote(vote))
        self._publish(self.evsw.fire_event, EVENT_VOTE, vote)

        if vote.msg_type == canonical.PREVOTE_TYPE:
            self._on_prevote_added(vote)
        else:
            self._on_precommit_added(vote)
        return True

    def _on_prevote_added(self, vote: Vote) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        maj23 = prevotes.two_thirds_majority()
        if maj23 is not None:
            # Track the latest valid block.  No unlocking here — 0.39
            # removed the unlock-on-later-polka rule (state.go:2260-2296).
            if (
                not maj23.is_nil()
                and rs.valid_round < vote.round == rs.round
            ):
                if (
                    rs.proposal_block is not None
                    and rs.proposal_block.hash() == maj23.hash
                ):
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    # We're getting the wrong block.
                    rs.proposal_block = None
                if (
                    rs.proposal_block_parts is None
                    or rs.proposal_block_parts.header != maj23.part_set_header
                ):
                    rs.proposal_block_parts = PartSet(maj23.part_set_header)
                self._publish(
                    self.evsw.fire_event, EVENT_VALID_BLOCK,
                    dataclasses.replace(rs),
                )

        if rs.round < vote.round and prevotes.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round)
        elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
            if maj23 is not None and (
                rs.proposal_complete() or maj23.is_nil()
            ):
                self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any():
                self._enter_prevote_wait(rs.height, vote.round)
        elif (
            rs.proposal is not None
            and 0 <= rs.proposal.pol_round == vote.round
        ):
            if rs.proposal_complete():
                self._enter_prevote(rs.height, rs.round)

    def _on_precommit_added(self, vote: Vote) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(vote.round)
        maj23 = precommits.two_thirds_majority()
        if maj23 is not None:
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit(rs.height, vote.round)
            if not maj23.is_nil():
                self._enter_commit(rs.height, vote.round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    self._enter_new_round(rs.height, 0)
            else:
                self._enter_precommit_wait(rs.height, vote.round)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit_wait(rs.height, vote.round)

    # -- own votes ---------------------------------------------------------

    def _sign_vote(
        self, msg_type: int, block_hash: bytes, part_set_header
    ) -> Vote | None:
        """state.go:2355 signVote."""
        rs = self.rs
        # barrier (defense in depth — _decide_proposal and _do_prevote
        # already fence): NO vote for H leaves this node until H-1 is
        # durable, so a crash can never forget a signature the network
        # already counted (the WAL double-sign guarantee, preserved
        # across the pipelined commit chain).  This is also what keeps
        # WAL replay sound: own H messages are always logged after the
        # worker's EndHeight(H-1) marker.
        self._wait_pipeline_durable(rs.height - 1)
        addr = bytes(self.priv_validator_pub_key.address())
        idx, val = rs.validators.get_by_address(addr)
        if val is None:
            return None
        block_id = (
            BlockID(block_hash, part_set_header) if block_hash else BlockID()
        )
        vote = Vote(
            msg_type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=block_id,
            timestamp_ns=self._clock.time_ns(),
            validator_address=addr,
            validator_index=idx,
        )
        extensions_enabled = rs.votes.extensions_enabled
        if (
            extensions_enabled
            and msg_type == canonical.PRECOMMIT_TYPE
            and not block_id.is_nil()
        ):
            vote.extension = self.block_exec.extend_vote(vote, self.state)
        self.priv_validator.sign_vote(
            self.state.chain_id, vote,
            sign_extension=extensions_enabled,
        )
        return vote

    def _sign_add_vote(
        self, msg_type: int, block_hash: bytes, part_set_header
    ) -> None:
        """state.go:2426 signAddVote."""
        rs = self.rs
        if self.priv_validator is None or self.priv_validator_pub_key is None:
            return
        if not rs.validators.has_address(
            bytes(self.priv_validator_pub_key.address())
        ):
            return
        try:
            vote = self._sign_vote(msg_type, block_hash, part_set_header)
        except FatalConsensusError:
            raise  # durability-barrier failure: fail-stop, never absorbed
        except Exception:
            # FilePV double-sign refusal — silent in replay, where the WAL
            # already carries the originally-signed vote (state.go:2426+).
            return
        if vote is not None:
            self._send_internal(VoteMessage(vote))

    # ------------------------------------------------------------------
    # WAL crash recovery (replay.go catchupReplay:94)
    # ------------------------------------------------------------------

    def _catchup_replay(self) -> None:
        height = self.rs.height
        msgs = self.wal.search_for_end_height(height - 1)
        if msgs is None:
            # A crash between save_block(h) and write_end_height(h) leaves
            # the WAL one marker BEHIND the store; the handshake already
            # replayed the block into the app, so everything after the
            # last marker concerns committed heights and is safely stale
            # (the state.go:1753-1820 crash matrix, cs-after-save-block
            # case). Only a WAL with no markers at all — it is seeded
            # with EndHeight(0) at creation — signals real corruption:
            # refusing to sign blindly is the whole point of the WAL
            # (replay.go:94). ONE scan finds the newest stale marker.
            from .wal import EndHeightMessage

            has_stale_marker = False
            for msg in self.wal.iter_messages():
                if (
                    isinstance(msg, EndHeightMessage)
                    and msg.height <= height - 1
                ):
                    has_stale_marker = True
            if has_stale_marker:
                msgs = []  # tail is pre-handshake noise, nothing to replay
        if msgs is None:
            raise ConsensusError(
                f"WAL has no #ENDHEIGHT marker at or below height "
                f"{height - 1}; refusing to start (possible WAL corruption)"
            )
        # Replay drives the live FSM handlers under the state mutex,
        # same as _locked_dispatch: on_start runs before the receive
        # routine spawns, so the lock is uncontended, and holding it
        # keeps the guarded-field invariant (every FSM write holds
        # 'consensus.state') uniform across replay and live operation.
        # The blocking/publish work reachable from the handlers is the
        # startup path of the same single-writer chain the baseline
        # documents for the live commit.
        # cometlint: disable=CLNT009,CLNT010 -- single-threaded startup replay; no routine exists to contend, and on_start's deferral buffer holds replay events until the mutex is released
        with self._mtx:
            self.replay_mode = True
            live_wal, self.wal = self.wal, NopWAL()
            try:
                for msg in msgs:
                    if isinstance(msg, MsgInfo):
                        self._handle_msg(msg)
                    elif isinstance(msg, TimeoutInfo):
                        self._handle_timeout(msg)
            finally:
                self.wal = live_wal
                self.replay_mode = False
