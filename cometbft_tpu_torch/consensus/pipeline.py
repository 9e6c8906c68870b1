"""Pipelined heights: the commit-boundary overlap engine.

The serial engine runs the whole commit chain — save_block, the WAL's
EndHeight fsync, ApplyBlock — on the FSM thread under `consensus.state`,
so the stages the per-height budget plane shows dominating commit
latency (wal_fsync, apply) serialize with next-height work by
construction.  This module hosts the three overlaps that remove them
from the serial span without weakening any durability invariant:

* **Speculative execution** (`cs-spec-exec` worker): at prevote time the
  FSM submits the block it just validated; the worker runs FinalizeBlock
  through the ABCI client's snapshot/finalize/restore sandwich
  (`abci/client.LocalClient.speculate_finalize`), so the app is
  bit-identical afterwards and a speculation that never wins needs no
  cleanup.  If the same block wins precommit, `_finalize_commit`
  consumes the memoized ``(response, post_token)`` instead of
  re-executing; a miss falls back to the serial FinalizeBlock.

* **Ordered commit-writer**: the durable suffix of every height —
  save_block -> WAL EndHeight fsync -> app Commit/state persist/prune/
  events — runs as ONE FIFO job off the FSM thread.  The order inside
  the job and across jobs is exactly the serial order, so every crash
  window maps onto the existing recovery matrix (WAL replay before
  save, handshake replay of the stored-but-unapplied tip after), and
  the handshake invariant "the app is never durably ahead of the block
  store" (consensus/replay.py) is preserved verbatim.

* **Durability barrier**: the FSM may PROCESS height H+1's proposal
  while H's job drains, but it must not SIGN any vote for H+1, reap the
  mempool for H+1's proposal, or prune state until H is durable —
  `wait_durable` is that fence (consensus/state.py calls it at
  decide-proposal, do-prevote and sign-vote; state/execution._prune
  caps pruning at `durable_height`).

Inline mode (`sim_driven` FSMs, or ``COMETBFT_TPU_PIPELINE=inline``)
runs both workers synchronously on the submitting thread: identical
code path and ring rows, zero added concurrency — the simnet
determinism pairs stay bit-reproducible.

Lock order: `consensus.state` -> `consensus.pipeline._mtx` (the FSM
enqueues and waits under its own mutex).  The workers hold
`consensus.pipeline._mtx` only to pop/publish — never while running a
job — and job bodies acquire the store/WAL/mempool/ABCI locks the
serial path already documents, so the pipeline mutex stays a leaf on
the worker side and the graph stays acyclic.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..abci.client import SpeculationUnsupported
from ..libs import devicefault
from ..libs import devledger as libdevledger
from ..libs import fail as libfail
from ..libs import health as libhealth
from ..libs import metrics as libmetrics
from ..libs import sync as libsync
from ..ops import verify as ov

# how long a barrier waiter tolerates an undrained commit-writer before
# declaring the pipeline wedged (a disk that slow trips the WAL's
# degraded state long before this); generous because the penalty for a
# false trip is a node fail-stop
BARRIER_TIMEOUT_S = 60.0
# bound on waiting for an in-flight speculation at consume time: by
# then the serial fallback costs one FinalizeBlock, so don't wait much
# longer than one typically takes
SPEC_CONSUME_WAIT_S = 5.0
_STOP = object()


def pipeline_mode() -> str:
    """COMETBFT_TPU_PIPELINE: "auto" (default — node boot turns the
    pipelined chain on for live nodes; sim-driven FSMs run inline),
    "on"/"1" force, "inline" run jobs synchronously on the submitting
    thread, "off"/"0" fully serial."""
    v = os.environ.get("COMETBFT_TPU_PIPELINE", "auto").lower()
    if v in ("1", "on", "true", "yes"):
        return "on"
    if v in ("0", "off", "false", "no"):
        return "off"
    if v == "inline":
        return "inline"
    return "auto"


def spec_mode() -> str:
    """COMETBFT_TPU_SPEC_EXEC: "auto" (default — on when the ABCI
    client supports the speculation extension), "on"/"1" force,
    "off"/"0" never speculate."""
    v = os.environ.get("COMETBFT_TPU_SPEC_EXEC", "auto").lower()
    if v in ("1", "on", "true", "yes"):
        return "on"
    if v in ("0", "off", "false", "no"):
        return "off"
    return "auto"


class PipelineError(Exception):
    """The commit-writer failed or wedged; the node must fail-stop
    (consensus/state.py converts this to FatalConsensusError)."""


class CommitPipeline:
    """Spec-exec worker + ordered commit-writer + durability barrier.

    One instance per node, wired by node boot (node/node.py) between
    the block executor and the consensus FSM.  All cross-thread state
    lives under ``consensus.pipeline._mtx``; the FSM is the only
    submitter, the two workers the only consumers.
    """

    def __init__(self, block_exec, wal, on_fatal=None, *, device="cuda"):
        ov.resolve_device(device)
        self.device = device  # where prestage_next warms the arena
        self.block_exec = block_exec
        self.wal = wal
        self.on_fatal = on_fatal
        self.enabled = False  # pipelined commit chain (knob-gated)
        self.spec_enabled = False  # speculative execution (knob-gated)
        # inline mode: execute jobs synchronously on the submitting
        # thread (sim_driven FSMs; COMETBFT_TPU_PIPELINE=inline)
        self.inline = False
        # flight-ring origin the workers declare (node boot sets it to
        # the same node-id prefix as the cs-receive thread)
        self.health_origin = 0
        self._mtx = libsync.Mutex("consensus.pipeline._mtx")
        self._cv = libsync.Condition(self._mtx, name="consensus.pipeline._mtx")
        # commit-writer state
        self._jobs: deque = deque()
        self._durable = 0  # highest height whose job completed
        self._enqueued = 0  # highest height handed to the writer
        self._error: BaseException | None = None
        self._stopping = False
        self._writer: threading.Thread | None = None
        # speculation slot (at most ONE in flight: the FSM only ever
        # speculates the block it is prevoting at its current height)
        self._spec_key = None  # (height, block_hash)
        self._spec_state = "idle"  # idle|pending|inflight|done|failed
        self._spec_thunk = None
        self._spec_result = None  # (resp, post_token, dur_ns)
        self._spec_thread: threading.Thread | None = None
        self._prestage_threads: list[threading.Thread] = []
        # the first exception a prestage warm-up raised: the FSM thread
        # raises it at its next prestage_next or at stop()
        self._prestage_error: BaseException | None = None
        # the first device fault a speculation raised: a miss would hide
        # it behind the serial FinalizeBlock, so it is raised alike
        self._spec_fault: BaseException | None = None

    # -- lifecycle ---------------------------------------------------------

    def note_base(self, height: int) -> None:
        """Seed the durable height at boot (state.last_block_height):
        everything at or below it is already fsynced by the serial
        paths that produced it."""
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            if height > self._durable:
                self._durable = height
            if height > self._enqueued:
                self._enqueued = height

    def durable_height(self) -> int:
        """The prune gate (state/execution.BlockExecutor.prune_gate):
        pruning must never outrun the fsynced suffix."""
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            return self._durable

    def _ensure_threads(self) -> None:
        # lazily, under _mtx: inline/sim runs never pay for threads
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._writer_run, name="cs-commit-writer", daemon=True
            )
            self._writer.start()
        if self.spec_enabled and self._spec_thread is None:
            self._spec_thread = threading.Thread(
                target=self._spec_run, name="cs-spec-exec", daemon=True
            )
            self._spec_thread.start()

    def stop(self, drain_s: float = 10.0) -> None:
        """Drain pending jobs (bounded), then stop both workers.  Must
        run BEFORE the WAL closes — the writer fsyncs through it."""
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            self._stopping = True
            deadline = time.monotonic() + drain_s
            while (
                self._jobs
                and self._error is None
                and time.monotonic() < deadline
            ):
                self._cv.wait(0.1)
            self._jobs.append(_STOP)
            self._cv.notify_all()
            # snapshot under the mutex; joins happen after release
            workers = (self._writer, self._spec_thread)
            prestage = list(self._prestage_threads)
        me = threading.current_thread()
        for t in workers:
            if t is not None and t is not me:
                t.join(timeout=5)
        for t in prestage:
            if t is not me:
                t.join(timeout=2)
        self.raise_prestage_error()

    def raise_prestage_error(self) -> None:
        """Raise what a finished prestage warm-up raised, or the device
        fault a speculation kept, once: a failed build or launch on the
        card must surface on the FSM thread."""
        err, self._prestage_error = self._prestage_error, None
        if err is not None:
            raise PipelineError(f"prestage warm-up failed: {err!r}") from err
        err, self._spec_fault = self._spec_fault, None
        if err is not None:
            raise PipelineError(
                f"speculative execution failed on the device: {err!r}"
            ) from err

    def _fatal(self, exc: BaseException) -> None:
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            if self._error is None:
                self._error = exc
            self._cv.notify_all()
        if self.on_fatal is not None:
            self.on_fatal(exc)

    # -- commit-writer -----------------------------------------------------

    def enqueue_commit(self, height: int, fn) -> None:
        """Hand one height's durable suffix to the ordered writer.
        ``fn`` is the whole job — save_block -> EndHeight fsync -> app
        commit/persist — built by the FSM with everything it needs
        bound in; the writer only supplies ordering, attribution and
        the durability handshake.  Inline mode runs it right here."""
        if self.inline:
            with libdevledger.caller_class("proposal"):
                fn()
            with self._mtx:
                libsync.lockset_note("CommitPipeline._durable")
                self._enqueued = max(self._enqueued, height)
                self._durable = max(self._durable, height)
            return
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            if self._error is not None:
                raise PipelineError(
                    f"commit-writer already failed: {self._error!r}"
                )
            if self._stopping:
                raise PipelineError("commit pipeline stopping")
            self._ensure_threads()
            self._jobs.append((height, fn))
            self._enqueued = max(self._enqueued, height)
            lag = self._enqueued - self._durable
            self._cv.notify_all()
        libmetrics.node_metrics().fsync_lag_heights.set(lag)

    def _writer_run(self) -> None:
        libhealth.set_thread_origin(self.health_origin)
        while True:
            with self._mtx:
                libsync.lockset_note("CommitPipeline._durable")
                while not self._jobs:
                    self._cv.wait(0.5)
                job = self._jobs.popleft()
            if job is _STOP:
                return
            height, fn = job
            try:
                # device tickets from save_block's merkle work and the
                # app-commit path belong to the block-production plane
                with libdevledger.caller_class("proposal"):
                    fn()
            except BaseException as e:  # noqa: BLE001 — fail-stop, never a silent dead writer
                import traceback

                traceback.print_exc()
                self._fatal(
                    e
                    if isinstance(e, Exception)
                    else PipelineError(f"commit-writer died: {e!r}")
                )
                return
            with self._mtx:
                libsync.lockset_note("CommitPipeline._durable")
                self._durable = max(self._durable, height)
                lag = self._enqueued - self._durable
                self._cv.notify_all()
            libmetrics.node_metrics().fsync_lag_heights.set(lag)

    def wait_durable(self, height: int, timeout_s: float | None = None) -> None:
        """Block until every height <= ``height`` is durable (saved +
        fsynced + applied).  The FSM calls this holding
        `consensus.state` — by design: the whole point is that the FSM
        must not advance past this fence.  Raises PipelineError on a
        failed writer or a wedge (caller fail-stops)."""
        if timeout_s is None:
            timeout_s = BARRIER_TIMEOUT_S
        with self._mtx:
            libsync.lockset_note("CommitPipeline._durable")
            # Only heights actually handed to the writer can be owed:
            # anything else (WAL catchup replay, blocksync/statesync
            # applies, pre-pipeline history) was made durable
            # synchronously by the serial path that produced it, so
            # waiting on it would wedge on a debt that does not exist.
            height = min(height, self._enqueued)
            if self._durable >= height:
                if self._error is not None:
                    raise PipelineError(
                        f"commit-writer failed: {self._error!r}"
                    )
                return
            deadline = time.monotonic() + timeout_s
            while self._durable < height and self._error is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PipelineError(
                        f"durability barrier wedged: height {height} not "
                        f"durable after {timeout_s:.0f}s "
                        f"(durable={self._durable})"
                    )
                self._cv.wait(min(remaining, 0.5))
            if self._error is not None:
                raise PipelineError(
                    f"commit-writer failed: {self._error!r}"
                )

    # -- speculation -------------------------------------------------------

    def submit_speculation(self, height: int, block_hash: bytes, thunk) -> None:
        """FSM, at prevote time, after validate_block passed: start
        FinalizeBlock speculatively for the block being prevoted.
        ``thunk()`` returns ``(resp, post_token)`` (built over
        BlockExecutor.speculate_block).  At most one speculation is
        live; a resubmit for the same key is a no-op, a different key
        supersedes (the old one counts as an abort)."""
        if not self.spec_enabled:
            return
        key = (height, bytes(block_hash))
        run_inline = False
        with self._mtx:
            libsync.lockset_note("CommitPipeline._spec_state")
            if self._spec_key == key and self._spec_state in (
                "pending", "inflight", "done"
            ):
                return
            if self._spec_state in ("pending", "done") or (
                self._spec_state == "inflight" and self._spec_key != key
            ):
                # superseded before consumption
                self._record_outcome(
                    self._spec_key[0] if self._spec_key else height,
                    0, libhealth.SPEC_ABORT, 0,
                )
            self._spec_key = key
            self._spec_thunk = thunk
            self._spec_result = None
            if self.inline:
                self._spec_state = "inflight"
                run_inline = True
            else:
                self._spec_state = "pending"
                self._ensure_threads()
                self._cv.notify_all()
        if run_inline:
            self._run_spec(key, thunk)

    def _spec_run(self) -> None:
        libhealth.set_thread_origin(self.health_origin)
        while True:
            with self._mtx:
                libsync.lockset_note("CommitPipeline._spec_state")
                while self._spec_state != "pending" and not self._stopping:
                    self._cv.wait(0.5)
                if self._stopping:
                    return
                self._spec_state = "inflight"
                key, thunk = self._spec_key, self._spec_thunk
            self._run_spec(key, thunk)

    def _run_spec(self, key, thunk) -> None:
        """Execute one speculation (worker thread, or the FSM thread in
        inline mode) and publish its result if the slot still wants it."""
        # The crash seam sits OUTSIDE the failure-absorbing try: a real
        # speculation error degrades to a serial commit, but an armed
        # crash point must kill the node — live runs os._exit inside
        # fail_point, simnet's handler raises and the exception
        # propagates to the (inline) FSM caller as a fatal.
        libfail.fail_point("cs-spec-exec")
        t0 = time.perf_counter()
        result = None
        failed = None
        try:
            # attribution: the speculative finalize is commit-side
            # verification work racing the vote gossip
            with libdevledger.caller_class("commit-verify"):
                resp, post = thunk()
            result = (resp, post, int((time.perf_counter() - t0) * 1e9))
        except SpeculationUnsupported:
            # the client/app pair can't sandbox — stop trying, forever
            # lockfree: boot-time knob plus this one-way False latch; GIL-atomic, and a stale True merely submits one more speculation that records 'unsupported' again
            self.spec_enabled = False
            failed = "unsupported"
        except Exception as e:
            import traceback

            traceback.print_exc()
            failed = "error"
            if devicefault.is_fault(e) and self._spec_fault is None:
                self._spec_fault = e
        with self._mtx:
            libsync.lockset_note("CommitPipeline._spec_state")
            if self._spec_key != key or self._spec_state != "inflight":
                # superseded while executing: the submitter already
                # recorded the abort
                return
            if failed is None:
                self._spec_state = "done"
                self._spec_result = result
            else:
                self._spec_state = "failed"
                self._spec_result = None
                if failed == "error":
                    self._record_outcome(
                        key[0], 0, libhealth.SPEC_ABORT, 0
                    )
            self._cv.notify_all()

    def consume_speculation(self, height: int, round_: int, block_hash: bytes):
        """FSM, at finalize-commit time: claim the memoized result for
        the block that won precommit.  Returns ``(resp, post_token)``
        on a hit, None on a miss (caller runs the serial FinalizeBlock).
        Waits briefly for an in-flight speculation of the RIGHT block —
        the work already happened, discarding it to re-execute would be
        strictly worse. A device fault that a speculation kept raises
        here as a PipelineError."""
        self.raise_prestage_error()
        if not self.spec_enabled:
            return None
        key = (height, bytes(block_hash))
        outcome = libhealth.SPEC_MISS
        dur_ns = 0
        result = None
        with self._mtx:
            libsync.lockset_note("CommitPipeline._spec_state")
            if self._spec_key == key:
                deadline = time.monotonic() + SPEC_CONSUME_WAIT_S
                while (
                    self._spec_state in ("pending", "inflight")
                    and time.monotonic() < deadline
                ):
                    self._cv.wait(0.2)
                if self._spec_state == "done":
                    resp, post, dur_ns = self._spec_result
                    result = (resp, post)
                    outcome = libhealth.SPEC_HIT
                self._spec_key = None
                self._spec_state = "idle"
                self._spec_thunk = None
                self._spec_result = None
            elif self._spec_state in ("pending", "done"):
                # we speculated some OTHER block and it lost
                self._record_outcome(
                    self._spec_key[0] if self._spec_key else height,
                    round_, libhealth.SPEC_ABORT, 0,
                )
                self._spec_key = None
                self._spec_state = "idle"
                self._spec_thunk = None
                self._spec_result = None
        self._record_outcome(height, round_, outcome, dur_ns)
        return result

    def _record_outcome(
        self, height: int, round_: int, outcome: int, dur_ns: int
    ) -> None:
        libhealth.record(
            libhealth.EV_SPEC, height, round_, outcome, dur_ns
        )
        libmetrics.node_metrics().spec_exec.labels(
            libhealth._SPEC_OUTCOMES[outcome]
        ).inc()

    # -- next-height prestaging --------------------------------------------

    def prestage_next(self, validator_set) -> None:
        """While H's durable suffix drains: warm H+1's device windows —
        the next validator set's expanded pubkeys into the PubkeyArena
        (crypto/batch.prestage_validators) and the hash plane's device
        path (crypto/hashplane.prewarm), so the proposer's PartSet
        build and the first verify windows of H+1 form without a cold
        start.  Pure cache warm-up: results are bit-identical with or
        without it, so inline/sim runs skip it entirely.

        Unlike the reference, a warm-up that raises is not swallowed:
        the thread keeps its exception and the next call (or ``stop``)
        raises it as a PipelineError on the FSM thread, which
        fail-stops the node. A failed build or launch never just
        disappears. While a warm-up still runs, a call starts no second
        one (the reference's would build the same keys beside it)."""
        if self.inline:
            return
        self.raise_prestage_error()
        alive = [t for t in self._prestage_threads if t.is_alive()]
        if alive:
            # a warm-up is still building (X1 on a cold arena): a second
            # one would build the same keys again beside it
            return

        def _warm(vs=validator_set):
            try:
                with libdevledger.caller_class("proposal"):
                    from ..crypto import batch as crypto_batch
                    from ..crypto import hashplane as crypto_hashplane

                    crypto_batch.prestage_validators(vs, device=self.device)
                    crypto_hashplane.prewarm()
            except BaseException as e:  # noqa: BLE001 - kept, raised on the FSM thread
                if self._prestage_error is None:
                    self._prestage_error = e

        t = threading.Thread(
            target=_warm, name="cs-prestage-next", daemon=True
        )
        t.start()
        alive.append(t)
        # lockfree: single-writer (FSM) list of daemon warm-up threads; stop() tolerates a stale snapshot — missing a just-spawned warmer only skips one bounded join of a side-effect-free daemon
        self._prestage_threads = alive
