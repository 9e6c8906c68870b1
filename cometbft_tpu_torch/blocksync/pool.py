"""Block download scheduler (reference: blocksync/pool.go:63-683).

Work-stealing pool: one requester per in-flight height, each picking an
available peer and re-picking (with the old peer banned for that height)
on timeout or bad data. The reactor consumes blocks strictly in order via
``peek_two_blocks`` → verify → ``pop_request``.

Port of cometbft_tpu/blocksync/pool.py, line for line, its constants the
reference's.
"""

from __future__ import annotations

from ..libs import sync as libsync
import time

REQUEST_WINDOW = 20  # max heights in flight (pool.go maxPendingRequests≈)
REQUEST_TIMEOUT = 15.0  # per-height peer response timeout
# Minimum bytes/sec a peer with pending requests must deliver, else it is
# evicted (pool.go:133-160 minRecvRate, 7680 B/s there). A peer trickling
# bytes under the request timeout would otherwise never be caught.
MIN_RECV_RATE = 7680
RATE_GRACE = 2.0  # monitor must run this long before a verdict


class _Peer:
    def __init__(self, peer_id: str, base: int, height: int):
        self.id = peer_id
        self.base = base
        self.height = height
        self.num_pending = 0
        self.timeout_count = 0
        self.recv_monitor = None  # armed while requests are pending
        self.monitor_start = 0.0

    def arm_monitor(self, now: float) -> None:
        """(Re)start rate tracking when pending goes 0 -> 1
        (pool.go resetMonitor). ``now`` comes from the pool's clock so
        the grace window stays on ONE timeline (the simnet drives the
        pool on virtual time)."""
        from ..libs.flowrate import Monitor

        self.recv_monitor = Monitor(window=5.0)
        self.monitor_start = now


class _Requester:
    def __init__(self, height: int):
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.ext_commit = None
        self.request_time = 0.0
        self.banned: set[str] = set()


class BlockPool:
    def __init__(self, start_height: int, send_request, on_peer_error=None,
                 min_recv_rate: int | None = None, now_fn=None):
        """``send_request(height, peer_id)`` dispatches a BlockRequest;
        ``on_peer_error(peer_id, reason)`` reports misbehaving peers.
        ``min_recv_rate``: B/s floor for peers with pending requests
        (0 disables; default MIN_RECV_RATE). ``now_fn``: monotonic
        seconds source for request timeouts (the simnet passes its
        virtual clock; default wall clock)."""
        self._mtx = libsync.RLock("blocksync.pool._mtx")
        self._now = now_fn if now_fn is not None else time.monotonic
        self.height = start_height  # next height to apply
        self.send_request = send_request
        self.on_peer_error = on_peer_error or (lambda pid, r: None)
        self.min_recv_rate = (
            MIN_RECV_RATE if min_recv_rate is None else min_recv_rate
        )
        self.peers: dict[str, _Peer] = {}
        self.requesters: dict[int, _Requester] = {}
        self.max_peer_height = 0
        self._running = True

    # -- peers -------------------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """StatusResponse from a peer (pool.go SetPeerRange)."""
        with self._mtx:
            p = self.peers.get(peer_id)
            if p is None:
                p = _Peer(peer_id, base, height)
                self.peers[peer_id] = p
            else:
                p.base, p.height = base, height
            self.max_peer_height = max(self.max_peer_height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self.peers.pop(peer_id, None)
            for r in self.requesters.values():
                if r.peer_id == peer_id and r.block is None:
                    r.peer_id = None  # re-dispatch
            self.max_peer_height = max(
                (p.height for p in self.peers.values()), default=0
            )

    def _pick_peer(self, height: int, banned: set[str]) -> _Peer | None:
        candidates = [
            p
            for p in self.peers.values()
            if p.base <= height <= p.height
            and p.id not in banned
            and p.num_pending < 10
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda p: p.num_pending)

    # -- scheduling (call periodically from the reactor loop) --------------

    def _evict_slow_peers(self, now: float) -> None:
        """Evict peers trickling below min_recv_rate while owing blocks
        (pool.go removeTimedoutPeers' rate branch)."""
        if self.min_recv_rate <= 0:
            return
        for peer in list(self.peers.values()):
            if peer.num_pending <= 0 or peer.recv_monitor is None:
                continue
            if now - peer.monitor_start < RATE_GRACE:
                continue
            rate = peer.recv_monitor.rate()
            # rate == 0 means nothing measured YET (the monitor is fed on
            # block receipt, and a first large block can legitimately
            # take longer than the grace period): only judge peers that
            # have delivered something slowly — pool.go's "curRate can
            # be 0 on start" guard. Fully silent peers fall to the
            # REQUEST_TIMEOUT path instead.
            if rate > 0 and rate < self.min_recv_rate:
                self.on_peer_error(
                    peer.id,
                    f"slow peer: {rate:.0f} B/s < {self.min_recv_rate} B/s "
                    f"with {peer.num_pending} pending",
                )
                self.remove_peer(peer.id)

    def make_requests(self) -> None:
        with self._mtx:
            if not self._running:
                return
            self._evict_slow_peers(self._now())
            for h in range(self.height, self.height + REQUEST_WINDOW):
                if self.max_peer_height and h > self.max_peer_height:
                    break
                r = self.requesters.get(h)
                if r is None:
                    r = _Requester(h)
                    self.requesters[h] = r
                if r.block is not None:
                    continue
                now = self._now()
                if r.peer_id is not None:
                    if now - r.request_time < REQUEST_TIMEOUT:
                        continue
                    # timeout: ban + re-pick
                    r.banned.add(r.peer_id)
                    peer = self.peers.get(r.peer_id)
                    if peer is not None:
                        peer.num_pending = max(0, peer.num_pending - 1)
                        peer.timeout_count += 1
                        if peer.timeout_count >= 3:
                            self.on_peer_error(peer.id, "repeated timeouts")
                    r.peer_id = None
                peer = self._pick_peer(h, r.banned)
                if peer is None:
                    r.banned.clear()  # all candidates banned: retry all
                    continue
                r.peer_id = peer.id
                r.request_time = now
                peer.num_pending += 1
                if peer.num_pending == 1:
                    peer.arm_monitor(now)
                self.send_request(h, peer.id)

    # -- block ingest ------------------------------------------------------

    def add_block(self, peer_id: str, block, ext_commit=None,
                  size: int = 0) -> bool:
        with self._mtx:
            peer = self.peers.get(peer_id)
            if peer is not None and peer.recv_monitor is not None and size:
                peer.recv_monitor.update(size)
            r = self.requesters.get(block.header.height)
            if r is None or r.peer_id != peer_id:
                # unsolicited — could be a late response; ignore
                return False
            if r.block is not None:
                return False
            r.block = block
            r.ext_commit = ext_commit
            peer = self.peers.get(peer_id)
            if peer is not None:
                peer.num_pending = max(0, peer.num_pending - 1)
                peer.timeout_count = 0
            return True

    def redo_request(self, height: int) -> None:
        """Block at ``height`` failed verification: ban the peer, refetch
        (pool.go RedoRequest)."""
        with self._mtx:
            r = self.requesters.get(height)
            if r is None:
                return
            if r.peer_id is not None:
                r.banned.add(r.peer_id)
                self.on_peer_error(r.peer_id, f"bad block {height}")
                self.remove_peer(r.peer_id)
            r.peer_id = None
            r.block = None
            r.ext_commit = None

    # -- ordered consumption ----------------------------------------------

    def peek_two_blocks(self):
        with self._mtx:
            r1 = self.requesters.get(self.height)
            r2 = self.requesters.get(self.height + 1)
            return (
                (r1.block if r1 else None),
                (r1.ext_commit if r1 else None),
                (r2.block if r2 else None),
            )

    def pop_request(self) -> None:
        with self._mtx:
            self.requesters.pop(self.height, None)
            self.height += 1

    def is_caught_up(self) -> bool:
        with self._mtx:
            if not self.peers:
                return False
            # maxPeerHeight - 1, NOT maxPeerHeight (pool.go IsCaughtUp):
            # the tip block can only be VERIFIED by the next block's
            # LastCommit, which doesn't exist yet — requiring equality
            # deadlocks a restarted validator against the very consensus
            # that needs it (peers can't produce block H+1 without us,
            # we wait in blocksync for H+1 to verify H, and wait_sync
            # drops every consensus vote meanwhile). The final block is
            # fetched by consensus catch-up gossip instead.
            return self.height >= self.max_peer_height - 1

    def stop(self) -> None:
        with self._mtx:
            self._running = False
