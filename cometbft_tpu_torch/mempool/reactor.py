"""Mempool gossip reactor (reference: mempool/reactor.go:138-210).

Channel ``0x30``. One broadcast thread per peer walks the mempool clist
and sends each tx, skipping peers that already sent it to us
(``isSender``, reactor.go:212) and peers that are still syncing.

Port of cometbft_tpu/mempool/reactor.py. The tx-lifecycle hook after the
first gossip send (``libtxtrace.note_gossip_send``) comes with
libs/txtrace, as the mempool's other txtrace hooks do. A device fault
that ``check_tx`` raises (its tx key on the hash plane) is not a
MempoolError: it leaves ``receive`` and the switch fail-stops the node.
"""

from __future__ import annotations

import threading

from ..libs import netstats as libnetstats
from ..p2p.base_reactor import ChannelDescriptor, Reactor
from .clist_mempool import CListMempool, MempoolError

MEMPOOL_CHANNEL = 0x30


class MempoolReactor(Reactor):
    def __init__(self, config, mempool: CListMempool):
        super().__init__("mempool-reactor")
        self.config = config
        self.mempool = mempool

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=MEMPOOL_CHANNEL, priority=5, send_queue_capacity=128
            )
        ]

    def add_peer(self, peer) -> None:
        if not self.config.broadcast:
            return
        threading.Thread(
            target=self._broadcast_tx_routine,
            args=(peer,),
            name=f"mempool-bcast-{peer.id[:8]}",
            daemon=True,
        ).start()

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        # tx gossip rides the stamped mempool channel: one-hop lag is
        # attributed under phase="tx" (raw tx payloads are safe to
        # stamp because stamping is negotiated, never sniffed)
        libnetstats.observe_propagation("tx")
        try:
            self.mempool.check_tx(msg_bytes, sender=peer.id)
        except MempoolError:
            pass  # dup/full/invalid — normal gossip noise

    def _broadcast_tx_routine(self, peer) -> None:
        """reactor.go:138 — tail the clist, skip the tx's senders."""
        el = None
        while peer.is_running() and self.is_running():
            if el is None:
                el = self.mempool.txs.front_wait(timeout=0.2)
                if el is None:
                    continue
            memtx = el.value
            if peer.id not in memtx.senders and not el.removed:
                if not peer.send(MEMPOOL_CHANNEL, memtx.tx):
                    continue  # retry same element
            nxt = el.next_wait(timeout=0.2)
            if nxt is not None:
                el = nxt
            elif el.removed:
                el = None  # restart from the front
