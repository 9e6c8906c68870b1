"""Consensus gossip reactor (reference: consensus/reactor.go).

Channels (reactor.go:27-30): State ``0x20`` (round steps, has-vote,
maj23 claims), Data ``0x21`` (proposals + block parts), Vote ``0x22``,
VoteSetBits ``0x23``. Per peer: a ``PeerState`` mirror of the remote
round state and two gossip threads (data + votes) plus a maj23 query
thread (reactor.go:563,731,886). Consensus-state events (via its evsw)
are re-broadcast to all peers.

Port of cometbft_tpu/consensus/reactor.py, line for line: the engine's
entry points (``add_vote_from_peer``, ``set_proposal_from_peer``,
``add_block_part_from_peer``) only queue, and the engine itself
fail-stops on a device fault (consensus/state).
"""

from __future__ import annotations

import random
import threading
from ..libs import sync as libsync
import time

from ..libs import log as _log
from ..libs import netstats as libnetstats
from ..libs.bits import BitArray
from ..p2p.base_reactor import ChannelDescriptor, Reactor
from ..types import canonical
from ..types import serialization as ser
from .messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
)
from .round_state import RoundStep
from .state import (
    EVENT_NEW_ROUND_STEP,
    EVENT_VALID_BLOCK,
    EVENT_VOTE,
)

def _gossip_log():
    """Logger for the per-peer gossip/query routines (lazy: honors
    whatever default logger the node configured after import)."""
    return _log.default_logger().with_module("consensus.reactor")


STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23


class PeerState:
    """Mirror of a peer's round state (reactor.go PeerState).

    ``rng`` seeds the vote-pick draw: the simnet plane injects a
    per-peer child rng so gossip schedules are reproducible from one
    seed; the default (module ``random``) keeps live-net behavior.
    """

    def __init__(self, rng=None):
        self._rng = rng if rng is not None else random
        self.mtx = libsync.RLock("consensus.reactor.mtx")
        self.height = 0
        self.round = -1
        self.step = RoundStep.NEW_HEIGHT
        self.start_time_ns = 0
        self.proposal = False
        self.proposal_block_parts_header = None
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: BitArray | None = None
        self.prevotes: dict[int, BitArray] = {}
        self.precommits: dict[int, BitArray] = {}

    # -- updates from messages --------------------------------------------

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        with self.mtx:
            new_height = msg.height != self.height
            new_round = new_height or msg.round != self.round
            self.height = msg.height
            self.round = msg.round
            self.step = RoundStep(msg.step)
            if new_round:
                self.proposal = False
                self.proposal_block_parts_header = None
                self.proposal_block_parts = None
                self.proposal_pol_round = -1
                self.proposal_pol = None
            if new_height:
                self.prevotes = {}
                self.precommits = {}
                self.last_commit_round = msg.last_commit_round
                self.last_commit = None
                self.catchup_commit_round = -1
                self.catchup_commit = None

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        with self.mtx:
            if self.height != msg.height:
                return
            if self.round != msg.round and not msg.is_commit:
                return
            self.proposal_block_parts_header = msg.block_part_set_header
            self.proposal_block_parts = msg.block_parts

    def set_has_proposal(self, proposal) -> None:
        with self.mtx:
            if self.height != proposal.height or self.round != proposal.round:
                return
            if self.proposal:
                return
            self.proposal = True
            if self.proposal_block_parts is None:
                self.proposal_block_parts_header = (
                    proposal.block_id.part_set_header
                )
                self.proposal_block_parts = BitArray(
                    proposal.block_id.part_set_header.total
                )
            self.proposal_pol_round = proposal.pol_round

    def set_has_block_part(self, height: int, round_: int, index: int) -> None:
        with self.mtx:
            if self.height != height or self.round != round_:
                return
            if self.proposal_block_parts is None:
                return
            self.proposal_block_parts.set_index(index, True)

    def _votes_bitarray(
        self, height: int, round_: int, msg_type: int, n_validators: int
    ) -> BitArray | None:
        if self.height == height:
            table = (
                self.prevotes
                if msg_type == canonical.PREVOTE_TYPE
                else self.precommits
            )
            if round_ not in table:
                table[round_] = BitArray(n_validators)
            return table[round_]
        if self.height == height + 1 and msg_type == canonical.PRECOMMIT_TYPE:
            if round_ == self.last_commit_round:
                if self.last_commit is None:
                    self.last_commit = BitArray(n_validators)
                return self.last_commit
        return None

    def set_has_vote(
        self, height: int, round_: int, msg_type: int, index: int,
        n_validators: int = 0,
    ) -> None:
        with self.mtx:
            ba = self._votes_bitarray(height, round_, msg_type, n_validators)
            if ba is not None and index < ba.size():
                ba.set_index(index, True)

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage, our_votes) -> None:
        """Overwrite our has-vote marks with the peer's OWN report
        (reactor.go ApplyVoteSetBitsMessage). This must be able to CLEAR
        bits, not just set them: a vote we sent while the peer was still
        syncing (wait_sync drops it) stays marked as delivered forever,
        and with it the liveness self-heal — the maj23 query → VoteSetBits
        reply loop is how a rejoining node gets its round's votes
        re-gossiped. For votes in ``our_votes`` the peer's word is
        authoritative; marks for votes we don't even have stay (we could
        never resend them anyway)."""
        with self.mtx:
            ba = self._votes_bitarray(
                msg.height, msg.round, msg.msg_type,
                msg.votes.size() if msg.votes else 0,
            )
            if ba is None or msg.votes is None:
                return
            if our_votes is None or our_votes.size() != ba.size():
                new = msg.votes
            else:
                new = ba.sub(our_votes).or_(msg.votes)
            for i in range(ba.size()):
                ba.set_index(
                    i, new.get_index(i) if i < new.size() else False
                )

    def pick_vote_to_send(self, votes) -> object | None:
        """A vote from ``votes`` (a VoteSet) the peer hasn't seen."""
        with self.mtx:
            if votes is None or votes.size() == 0:
                return None
            ba = self._votes_bitarray(
                votes.height, votes.round, votes.signed_msg_type, votes.size()
            )
            if ba is None:
                return None
            candidates = [
                i
                for i in range(votes.size())
                if votes.get_by_index(i) is not None and not ba.get_index(i)
            ]
            if not candidates:
                return None
            return votes.get_by_index(self._rng.choice(candidates))


class ConsensusReactor(Reactor):
    def __init__(self, consensus_state, wait_sync: bool = False):
        super().__init__("consensus-reactor")
        self.cs = consensus_state
        self.wait_sync = wait_sync  # True while blocksync runs
        self._gossip_sleep = (
            self.cs.config.peer_gossip_sleep_duration_ns / 1e9
        )
        self._maj23_sleep = (
            self.cs.config.peer_query_maj23_sleep_duration_ns / 1e9
        )

    # -- channels (reactor.go GetChannels) ---------------------------------

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=STATE_CHANNEL, priority=6, send_queue_capacity=64
            ),
            ChannelDescriptor(
                id=DATA_CHANNEL, priority=10, send_queue_capacity=100
            ),
            ChannelDescriptor(
                id=VOTE_CHANNEL, priority=7, send_queue_capacity=100
            ),
            ChannelDescriptor(
                id=VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=4
            ),
        ]

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._subscribe_events()
        if not self.wait_sync and not self.cs.is_running():
            self.cs.start()

    def on_stop(self) -> None:
        self.cs.evsw.remove_listener("cs-reactor")
        if self.cs.is_running():
            self.cs.stop()

    def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Blocksync finished → start the FSM (reactor.go:109).

        ``wait_sync`` must drop BEFORE update_to_state broadcasts the new
        height: once peers see it they catch-up-gossip votes exactly once,
        and a still-syncing reactor would silently drop them."""
        self.wait_sync = False
        # This runs on the blocksync pool routine while the node's other
        # threads are live — mutating FSM state needs the state mutex,
        # exactly like the reference (reactor.go:109 takes conS.mtx
        # before updateToState). update_to_state publishes the new-step
        # event; deferral delivers it only after the mutex is released,
        # same as the FSM receive loop.
        with self.cs._deferred_events():
            with self.cs._mtx:
                self.cs.update_to_state(state)
                self.cs.reconstruct_last_commit_if_needed(state)
                self.cs.do_wal_catchup = not skip_wal
        self.cs.start()

    # -- event re-broadcast (reactor.go:415-530) ---------------------------

    def _subscribe_events(self) -> None:
        self.cs.evsw.add_listener_for_event(
            "cs-reactor", EVENT_NEW_ROUND_STEP, self._on_new_round_step
        )
        self.cs.evsw.add_listener_for_event(
            "cs-reactor", EVENT_VALID_BLOCK, self._on_valid_block
        )
        self.cs.evsw.add_listener_for_event(
            "cs-reactor", EVENT_VOTE, self._on_vote_event
        )

    def _round_step_msg(self, rs) -> NewRoundStepMessage:
        return NewRoundStepMessage(
            height=rs.height,
            round=rs.round,
            step=int(rs.step),
            seconds_since_start_time=max(
                0, int((self.cs._clock.time_ns() - rs.start_time_ns) / 1e9)
            ),
            last_commit_round=(
                rs.last_commit.round if rs.last_commit is not None else -1
            ),
        )

    def _on_new_round_step(self, rs) -> None:
        if self.switch is not None:
            self.switch.try_broadcast(
                STATE_CHANNEL, ser.dumps(self._round_step_msg(rs))
            )

    def _on_valid_block(self, rs) -> None:
        if self.switch is None or rs.proposal_block_parts is None:
            return
        msg = NewValidBlockMessage(
            height=rs.height,
            round=rs.round,
            block_part_set_header=rs.proposal_block_parts.header,
            block_parts=rs.proposal_block_parts.parts_bit_array.copy(),
            is_commit=rs.step == RoundStep.COMMIT,
        )
        self.switch.try_broadcast(STATE_CHANNEL, ser.dumps(msg))

    def _on_vote_event(self, vote) -> None:
        if self.switch is None:
            return
        msg = HasVoteMessage(
            height=vote.height,
            round=vote.round,
            msg_type=vote.msg_type,
            index=vote.validator_index,
        )
        self.switch.try_broadcast(STATE_CHANNEL, ser.dumps(msg))

    # -- peer lifecycle ----------------------------------------------------

    def init_peer(self, peer) -> None:
        peer.set(
            "consensus_peer_state",
            PeerState(rng=getattr(peer, "gossip_rng", None)),
        )

    def add_peer(self, peer) -> None:
        ps = peer.get("consensus_peer_state")
        # Announce our current step so the peer can route gossip — but
        # NOT while we're still syncing (reactor.go AddPeer: "If we're
        # syncing, broadcast a RoundStepMessage later upon
        # SwitchToConsensus"). Announcing invites vote gossip that
        # wait_sync DROPS while the sender marks it delivered — a
        # restarting validator then wedges missing exactly those votes.
        # switch_to_consensus broadcasts the round step when we're ready.
        if not self.wait_sync:
            rs = self.cs.get_round_state()
            peer.try_send(STATE_CHANNEL, ser.dumps(self._round_step_msg(rs)))
        if getattr(peer, "sim_driven", False):
            # simnet peers: the scheduler drives the three per-peer
            # routines as virtual-time ticks (_gossip_data_once /
            # _gossip_votes_once / _query_maj23_once) — spawning the
            # thread-per-peer loops here would reintroduce wall-clock
            # nondeterminism and break at N=100+ nodes
            return
        for fn, name in (
            (self._gossip_data_routine, "gossip-data"),
            (self._gossip_votes_routine, "gossip-votes"),
            (self._query_maj23_routine, "maj23"),
        ):
            threading.Thread(
                target=fn, args=(peer, ps), name=f"{name}-{peer.id[:8]}",
                daemon=True,
            ).start()

    def remove_peer(self, peer, reason) -> None:
        pass  # routines exit when the peer stops

    # -- receive dispatch (reactor.go Receive:233) -------------------------

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        msg = ser.loads(msg_bytes)
        ps: PeerState = peer.get("consensus_peer_state")
        if ps is None:
            return
        if ch_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                if msg.step == int(RoundStep.COMMIT):
                    # the peer's step broadcast entering COMMIT is the
                    # reliable per-height commit announcement (the
                    # NewValidBlock is_commit path below only fires on
                    # catch-up edges) — the commit leg of the
                    # proposal→prevote→precommit→commit chain
                    libnetstats.observe_propagation("commit", msg.height)
                ps.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                if msg.is_commit:
                    # the peer announced a committed block: the commit
                    # leg of the proposal→…→commit propagation chain
                    libnetstats.observe_propagation("commit", msg.height)
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.set_has_vote(
                    msg.height, msg.round, msg.msg_type, msg.index,
                    len(self.cs.get_round_state().validators or ()),
                )
            elif isinstance(msg, VoteSetMaj23Message):
                self._handle_maj23(peer, ps, msg)
        elif ch_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, ProposalMessage):
                libnetstats.observe_propagation(
                    "proposal", msg.proposal.height
                )
                ps.set_has_proposal(msg.proposal)
                self.cs.set_proposal_from_peer(msg.proposal, peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                with ps.mtx:
                    if ps.height == msg.height:
                        ps.proposal_pol_round = msg.proposal_pol_round
                        ps.proposal_pol = msg.proposal_pol
            elif isinstance(msg, BlockPartMessage):
                libnetstats.observe_propagation("block_part", msg.height)
                ps.set_has_block_part(msg.height, msg.round, msg.part.index)
                self.cs.add_block_part_from_peer(
                    msg.height, msg.round, msg.part, peer.id
                )
        elif ch_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, VoteMessage):
                libnetstats.observe_propagation(
                    "prevote"
                    if msg.vote.msg_type == canonical.PREVOTE_TYPE
                    else "precommit",
                    msg.vote.height,
                )
                rs = self.cs.get_round_state()
                ps.set_has_vote(
                    msg.vote.height, msg.vote.round, msg.vote.msg_type,
                    msg.vote.validator_index,
                    len(rs.validators or ()),
                )
                self.cs.add_vote_from_peer(msg.vote, peer.id)
        elif ch_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                # our own bits for the claimed block decide which of the
                # peer's reports are authoritative (reactor.go:316-330)
                rs = self.cs.get_round_state()
                our = None
                if rs.height == msg.height and rs.votes is not None:
                    vs = (
                        rs.votes.prevotes(msg.round)
                        if msg.msg_type == canonical.PREVOTE_TYPE
                        else rs.votes.precommits(msg.round)
                    )
                    if vs is not None:
                        our = vs.bit_array_by_block_id(msg.block_id)
                ps.apply_vote_set_bits(msg, our)

    def _handle_maj23(self, peer, ps: PeerState, msg: VoteSetMaj23Message):
        """reactor.go: record claim, respond with our vote bits."""
        rs = self.cs.get_round_state()
        if rs.height != msg.height or rs.votes is None:
            return
        try:
            rs.votes.set_peer_maj23(msg.round, msg.msg_type, peer.id, msg.block_id)
        except Exception:
            return
        vs = (
            rs.votes.prevotes(msg.round)
            if msg.msg_type == canonical.PREVOTE_TYPE
            else rs.votes.precommits(msg.round)
        )
        if vs is None:
            return
        our = vs.bit_array_by_block_id(msg.block_id)
        peer.try_send(
            VOTE_SET_BITS_CHANNEL,
            ser.dumps(
                VoteSetBitsMessage(
                    height=msg.height,
                    round=msg.round,
                    msg_type=msg.msg_type,
                    block_id=msg.block_id,
                    votes=our,
                )
            ),
        )

    # -- gossip: data (reactor.go:563) -------------------------------------

    def _gossip_data_routine(self, peer, ps: PeerState) -> None:
        while peer.is_running() and self.is_running():
            rs = self.cs.get_round_state()
            try:
                if self._gossip_data_once(peer, ps, rs):
                    continue
            except Exception as e:  # CLNT006: keep gossiping, but say why
                _gossip_log().debug(
                    "gossip data failed; retrying after sleep",
                    peer=str(getattr(peer, "id", "?"))[:16],
                    err=repr(e)[:120],
                )
            time.sleep(self._gossip_sleep)

    def _gossip_data_once(self, peer, ps: PeerState, rs) -> bool:
        # 1. our proposal block parts the peer lacks (same H/R)
        if (
            rs.proposal_block_parts is not None
            and ps.height == rs.height
            and ps.proposal_block_parts is not None
            and ps.proposal_block_parts_header == rs.proposal_block_parts.header
        ):
            have = rs.proposal_block_parts.parts_bit_array
            for i in range(rs.proposal_block_parts.header.total):
                if have.get_index(i) and not ps.proposal_block_parts.get_index(i):
                    part = rs.proposal_block_parts.get_part(i)
                    if part is not None and peer.send(
                        DATA_CHANNEL,
                        ser.dumps(BlockPartMessage(rs.height, rs.round, part)),
                    ):
                        ps.set_has_block_part(rs.height, rs.round, i)
                        return True
                    return False
        # 2. peer is catching up: send parts of their next block
        if ps.height > 0 and ps.height < rs.height:
            return self._gossip_catchup_part(peer, ps)
        # 3. the proposal itself
        if rs.proposal is not None and ps.height == rs.height and not ps.proposal:
            if peer.send(
                DATA_CHANNEL, ser.dumps(ProposalMessage(rs.proposal))
            ):
                ps.set_has_proposal(rs.proposal)
                # POL info lets the peer verify an old-round proposal
                if 0 <= rs.proposal.pol_round:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        peer.send(
                            DATA_CHANNEL,
                            ser.dumps(
                                ProposalPOLMessage(
                                    height=rs.height,
                                    proposal_pol_round=rs.proposal.pol_round,
                                    proposal_pol=pol.bit_array(),
                                )
                            ),
                        )
                return True
        return False

    def _gossip_catchup_part(self, peer, ps: PeerState) -> bool:
        """reactor.go gossipDataForCatchup:679."""
        store = self.cs.block_store
        meta = store.load_block_meta(ps.height) if store else None
        if meta is None:
            return False
        with ps.mtx:
            header_ok = (
                ps.proposal_block_parts_header
                == meta.block_id.part_set_header
                and ps.proposal_block_parts is not None
            )
        if not header_ok:
            return False
        for i in range(meta.block_id.part_set_header.total):
            if not ps.proposal_block_parts.get_index(i):
                part = store.load_block_part(ps.height, i)
                if part is None:
                    return False
                if peer.send(
                    DATA_CHANNEL,
                    ser.dumps(BlockPartMessage(ps.height, ps.round, part)),
                ):
                    ps.set_has_block_part(ps.height, ps.round, i)
                    return True
                return False
        return False

    # -- gossip: votes (reactor.go:731) ------------------------------------

    def _gossip_votes_routine(self, peer, ps: PeerState) -> None:
        while peer.is_running() and self.is_running():
            rs = self.cs.get_round_state()
            try:
                if self._gossip_votes_once(peer, ps, rs):
                    continue
            except Exception as e:  # CLNT006: keep gossiping, but say why
                _gossip_log().debug(
                    "gossip votes failed; retrying after sleep",
                    peer=str(getattr(peer, "id", "?"))[:16],
                    err=repr(e)[:120],
                )
            time.sleep(self._gossip_sleep)

    def _gossip_votes_once(self, peer, ps: PeerState, rs) -> bool:
        if rs.votes is None:
            return False
        # same height: peer's round votes, POL prevotes, our last commit
        if ps.height == rs.height:
            for votes in (
                rs.votes.prevotes(ps.round) if ps.round >= 0 else None,
                rs.votes.precommits(ps.round) if ps.round >= 0 else None,
            ):
                if votes is not None and self._send_vote_from(peer, ps, votes):
                    return True
        if (
            ps.height + 1 == rs.height
            and rs.last_commit is not None
        ):
            if self._send_vote_from(peer, ps, rs.last_commit):
                return True
        # deep catchup: votes from the stored commit of the peer's height
        if ps.height > 0 and ps.height < rs.height - 1:
            return self._gossip_catchup_commit_votes(peer, ps)
        return False

    def _send_vote_from(self, peer, ps: PeerState, votes) -> bool:
        vote = ps.pick_vote_to_send(votes)
        if vote is None:
            return False
        if peer.send(VOTE_CHANNEL, ser.dumps(VoteMessage(vote))):
            ps.set_has_vote(
                vote.height, vote.round, vote.msg_type, vote.validator_index,
                votes.size(),
            )
            return True
        return False

    def _gossip_catchup_commit_votes(self, peer, ps: PeerState) -> bool:
        store = self.cs.block_store
        commit = store.load_block_commit(ps.height) if store else None
        if commit is None:
            return False
        # send one commit-sig as a vote the peer lacks
        with ps.mtx:
            ba = ps.precommits.setdefault(
                commit.round, BitArray(commit.size())
            )
        for idx, cs_sig in enumerate(commit.signatures):
            if cs_sig.block_id_flag == 1:  # absent
                continue
            if ba is not None and ba.get_index(idx):
                continue
            from ..types.vote import Vote

            vote = Vote(
                msg_type=canonical.PRECOMMIT_TYPE,
                height=ps.height,
                round=commit.round,
                block_id=cs_sig.block_id(commit.block_id),
                timestamp_ns=cs_sig.timestamp_ns,
                validator_address=cs_sig.validator_address,
                validator_index=idx,
                signature=cs_sig.signature,
            )
            if peer.send(VOTE_CHANNEL, ser.dumps(VoteMessage(vote))):
                ps.set_has_vote(
                    ps.height, commit.round, canonical.PRECOMMIT_TYPE, idx,
                    commit.size(),
                )
                return True
            return False
        return False

    # -- maj23 queries (reactor.go:886) ------------------------------------

    def _query_maj23_routine(self, peer, ps: PeerState) -> None:
        while peer.is_running() and self.is_running():
            rs = self.cs.get_round_state()
            try:
                self._query_maj23_once(peer, ps, rs)
            except Exception as e:  # CLNT006: keep querying, but say why
                _gossip_log().debug(
                    "maj23 query failed; retrying after sleep",
                    peer=str(getattr(peer, "id", "?"))[:16],
                    err=repr(e)[:120],
                )
            time.sleep(self._maj23_sleep)

    def _query_maj23_once(self, peer, ps: PeerState, rs) -> None:
        """One maj23 probe toward ``peer`` (the routine's body; also the
        simnet tick)."""
        if rs.votes is not None and ps.height == rs.height:
            for msg_type, vs in (
                (canonical.PREVOTE_TYPE, rs.votes.prevotes(rs.round)),
                (
                    canonical.PRECOMMIT_TYPE,
                    rs.votes.precommits(rs.round),
                ),
            ):
                if vs is None:
                    continue
                maj = vs.two_thirds_majority()
                if maj is not None:
                    peer.try_send(
                        STATE_CHANNEL,
                        ser.dumps(
                            VoteSetMaj23Message(
                                height=rs.height,
                                round=rs.round,
                                msg_type=msg_type,
                                block_id=maj,
                            )
                        ),
                    )
        # Catch-up query (reactor.go:938-960): a peer stuck on an
        # OLDER height is asked against our STORED commit. Its
        # VoteSetBits reply exposes which precommits it actually
        # holds, clearing stale has-vote marks (votes we sent
        # while it was syncing were dropped but stayed marked) so
        # the last-commit/catch-up gossip resends them — without
        # this, a validator that restarts during its own commit
        # wedges one height behind forever.
        elif (
            ps.height > 0
            and ps.height < rs.height
            and self.cs.block_store is not None
        ):
            commit = self.cs.block_store.load_block_commit(ps.height)
            if commit is not None:
                peer.try_send(
                    STATE_CHANNEL,
                    ser.dumps(
                        VoteSetMaj23Message(
                            height=ps.height,
                            round=commit.round,
                            msg_type=canonical.PRECOMMIT_TYPE,
                            block_id=commit.block_id,
                        )
                    ),
                )
