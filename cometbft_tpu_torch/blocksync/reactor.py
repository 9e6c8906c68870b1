"""Blocksync reactor (reference: blocksync/reactor.go, channel 0x40).

Serves stored blocks to catching-up peers and, while syncing, drives the
pool: request blocks → verify the first of each pair via the second's
LastCommit (VerifyCommitLight — the batched hot path, reactor.go:447) →
ApplyBlock → switch to consensus when caught up (reactor.go:383-386).

Port of cometbft_tpu/blocksync/reactor.py. ``device`` (default the GPU;
raises without one) is resolved at construction and is where
``verify_commit_light`` runs (K2 on the arena, K1 with it off). A device
fault, marked where it left the batch verifier (libs/devicefault), is
not a bad block: no height is redone and no peer punished. It leaves
``_pool_step`` with every other local failure, and the pool routine
fail-stops the node through ``on_fatal`` (without one, the process exits)
where the reference's thread would die alone.
"""

from __future__ import annotations

import os
import threading
import time

from ..libs import devicefault
from ..libs import netstats as libnetstats
from ..libs import trace as libtrace
from ..ops import verify as ov
from ..p2p.base_reactor import ChannelDescriptor, Reactor
from ..types import serialization as ser
from ..types.validation import VerificationError, verify_commit_light
from .messages import (
    BlockRequestMessage,
    BlockResponseMessage,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
)
from .pool import BlockPool

BLOCKSYNC_CHANNEL = 0x40
STATUS_INTERVAL = 5.0
SWITCH_TO_CONSENSUS_INTERVAL = 1.0


class BlocksyncReactor(Reactor):
    def __init__(
        self,
        state,  # sm.State at boot
        block_exec,
        block_store,
        block_sync: bool,
        consensus_reactor=None,  # for switch_to_consensus
        min_recv_rate: int | None = None,
        now_fn=None,
        *,
        device="cuda",
    ):
        ov.resolve_device(device)
        super().__init__("blocksync-reactor")
        self.device = device
        # Fail-stop hook for a local failure of the sync loop (the node
        # wires it to a full stop; None -> os._exit)
        self.on_fatal = None
        self.initial_state = state
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.block_sync = block_sync
        self.consensus_reactor = consensus_reactor
        self.min_recv_rate = min_recv_rate
        # monotonic-seconds source for the pool loop's status/timeout
        # cadence; the simnet substitutes its virtual clock and drives
        # _pool_step from its scheduler instead of the pool thread
        self._now = now_fn if now_fn is not None else time.monotonic
        self.sim_driven = False
        self.pool = BlockPool(
            block_store.height() + 1,
            send_request=self._send_block_request,
            on_peer_error=self._on_pool_peer_error,
            min_recv_rate=min_recv_rate,
            now_fn=now_fn,
        )
        self.synced = threading.Event()
        self._n_synced = 0
        # _pool_step cadence state (locals of the reference's
        # poolRoutine; -inf = the first step broadcasts/checks
        # immediately on ANY clock, including the sim clock at t~0)
        self._last_status = float("-inf")
        self._last_switch_check = float("-inf")
        self._caught_up_since: float | None = None
        if not block_sync:
            self.synced.set()

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=BLOCKSYNC_CHANNEL,
                priority=5,
                send_queue_capacity=1000,
                recv_message_capacity=50 * 1024 * 1024,
            )
        ]

    def on_start(self) -> None:
        if self.block_sync and not self.sim_driven:
            threading.Thread(
                target=self._pool_routine, name="blocksync-pool", daemon=True
            ).start()

    def switch_to_block_sync(self, state) -> None:
        """Statesync finished: start block-syncing FROM the restored state
        (reactor.go SwitchToBlockSync). Rebuilds the pool at the restored
        height — the one chosen at construction assumed genesis."""
        self.state = state
        self.block_sync = True
        self.synced.clear()
        self._last_status = float("-inf")
        self._last_switch_check = float("-inf")
        self._caught_up_since = None
        self.pool = BlockPool(
            state.last_block_height + 1,
            send_request=self._send_block_request,
            on_peer_error=self._on_pool_peer_error,
            min_recv_rate=self.min_recv_rate,
            now_fn=None if self._now is time.monotonic else self._now,
        )
        # re-announce status so peers learn we now need blocks
        self._broadcast_status_request()
        if not self.sim_driven:
            threading.Thread(
                target=self._pool_routine, name="blocksync-pool", daemon=True
            ).start()

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer) -> None:
        peer.try_send(
            BLOCKSYNC_CHANNEL,
            ser.dumps(
                StatusResponseMessage(
                    height=self.block_store.height(),
                    base=self.block_store.base(),
                )
            ),
        )

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    # -- receive (reactor.go Receive) --------------------------------------

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = ser.loads(msg_bytes)
        if isinstance(msg, StatusRequestMessage):
            peer.try_send(
                BLOCKSYNC_CHANNEL,
                ser.dumps(
                    StatusResponseMessage(
                        height=self.block_store.height(),
                        base=self.block_store.base(),
                    )
                ),
            )
        elif isinstance(msg, StatusResponseMessage):
            self.pool.set_peer_range(peer.id, msg.base, msg.height)
        elif isinstance(msg, BlockRequestMessage):
            block = self.block_store.load_block(msg.height)
            if block is None:
                peer.try_send(
                    BLOCKSYNC_CHANNEL,
                    ser.dumps(NoBlockResponseMessage(height=msg.height)),
                )
                return
            ext = self.block_store.load_block_extended_commit(msg.height)
            peer.try_send(
                BLOCKSYNC_CHANNEL,
                ser.dumps(BlockResponseMessage(block=block, ext_commit=ext)),
            )
        elif isinstance(msg, BlockResponseMessage):
            # one-hop serve latency of a synced block (provenance stamp)
            libnetstats.observe_propagation("block", msg.block.header.height)
            self.pool.add_block(
                peer.id, msg.block, msg.ext_commit, size=len(msg_bytes)
            )
        elif isinstance(msg, NoBlockResponseMessage):
            pass  # the requester will time out and re-pick

    # -- pool plumbing -----------------------------------------------------

    def _send_block_request(self, height: int, peer_id: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.get_peer(peer_id)
        if peer is not None:
            peer.try_send(
                BLOCKSYNC_CHANNEL, ser.dumps(BlockRequestMessage(height))
            )

    def _on_pool_peer_error(self, peer_id: str, reason) -> None:
        if self.switch is None:
            return
        peer = self.switch.get_peer(peer_id)
        if peer is not None:
            self.switch.stop_and_remove_peer(peer, reason)

    def _broadcast_status_request(self) -> None:
        if self.switch is not None:
            self.switch.try_broadcast(
                BLOCKSYNC_CHANNEL, ser.dumps(StatusRequestMessage())
            )

    # -- the sync loop (reactor.go:272 poolRoutine) ------------------------

    # _pool_step outcomes
    STEP_IDLE = 0  # nothing applied; caller may sleep a beat
    STEP_APPLIED = 1  # a block landed; step again immediately
    STEP_SWITCHED = 2  # handed off to consensus; the loop is done

    def _pool_routine(self) -> None:
        while not self.quit_event().is_set():
            try:
                outcome = self._pool_step(self._now())
            except Exception as e:
                self._fail_stop(e)
                return
            if outcome == self.STEP_SWITCHED:
                return
            if outcome == self.STEP_IDLE:
                time.sleep(0.05)

    def _pool_step(self, now: float) -> int:
        """One iteration of the sync loop (also the simnet tick: the
        scheduler calls it with virtual ``now``)."""
        if now - self._last_status > STATUS_INTERVAL:
            self._broadcast_status_request()
            self._last_status = now
        self.pool.make_requests()

        # Try to verify+apply the next block.
        first, first_ext, second = self.pool.peek_two_blocks()
        if first is not None and second is not None:
            try:
                self._apply_first(first, first_ext, second)
            except Exception:
                import traceback

                traceback.print_exc()
                raise  # local apply failure: fail-stop (reference panics)
            return self.STEP_APPLIED

        # Caught up? Need a stable signal before switching.
        if now - self._last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
            self._last_switch_check = now
            if self.pool.is_caught_up():
                if self._caught_up_since is None:
                    self._caught_up_since = now
                elif (
                    now - self._caught_up_since
                    > SWITCH_TO_CONSENSUS_INTERVAL
                ):
                    self._switch_to_consensus()
                    return self.STEP_SWITCHED
            else:
                self._caught_up_since = None
        return self.STEP_IDLE

    def _fail_stop(self, err: BaseException) -> None:
        """A block that passed its commit check did not apply, or the
        device path failed: stop the node (the reference panics)."""
        if self.on_fatal is not None:
            self.on_fatal(err)
            return
        os._exit(1)

    def _apply_first(self, first, first_ext, second) -> None:
        """reactor.go:447: first's validity is proven by second.LastCommit."""
        from ..types import BlockID, PartSet

        t0 = time.perf_counter() if libtrace.enabled() else 0.0
        parts = PartSet.from_data(ser.dumps(first))
        first_id = BlockID(first.hash(), parts.header)
        try:
            if second.last_commit is None:
                raise VerificationError("second block missing last commit")
            if second.last_commit.block_id != first_id:
                raise VerificationError("second block commits a fork?")
            from ..libs import devledger

            with devledger.caller_class("blocksync"):
                verify_commit_light(
                    self.state.chain_id,
                    self.state.validators,
                    first_id,
                    first.header.height,
                    second.last_commit,
                    device=self.device,
                )  # ◄◄ HOT BATCH (types/validation.go, K2 on the card)
        except (VerificationError, ValueError) as e:
            if devicefault.is_fault(e):
                raise  # the card failed, not the block: fail-stop
            # Either block may be the forged one: redo BOTH and punish both
            # serving peers (reactor.go:447-470).
            if t0:
                libtrace.event(
                    "blocksync.reject", height=first.header.height
                )
            self.pool.redo_request(first.header.height)
            self.pool.redo_request(second.header.height)
            return
        seen_commit = second.last_commit
        if self.block_store.height() < first.header.height:
            if first_ext is not None and self.state.consensus_params.vote_extensions_enabled(
                first.header.height
            ):
                self.block_store.save_block_with_extended_commit(
                    first, parts, first_ext
                )
            else:
                self.block_store.save_block(first, parts, seen_commit)
        # ApplyBlock failure on a commit-verified block is a LOCAL fault —
        # fail-stop like the reference's panic, never punish the peer.
        self.state = self.block_exec.apply_block(self.state, first_id, first)
        if t0:
            libtrace.event(
                "blocksync.apply",
                height=first.header.height,
                lanes=len(seen_commit.signatures),
                dur_ns=int((time.perf_counter() - t0) * 1e9),
            )
        self._n_synced += 1
        self.pool.pop_request()

    def _switch_to_consensus(self) -> None:
        """reactor.go:383-386 → consensus/reactor.go:109."""
        if self.logger is not None:
            self.logger.info(
                "switching to consensus",
                height=self.block_store.height(),
                blocks_synced=self._n_synced,
            )
        self.pool.stop()
        self.synced.set()
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(
                self.state, skip_wal=self._n_synced > 0
            )
