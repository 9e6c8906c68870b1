"""Evidence gossip reactor (reference: evidence/reactor.go, channel 0x38).

Clist-tailing broadcast like the mempool reactor; received evidence goes
through the pool's full verification before being gossiped onward.

Port of cometbft_tpu/evidence/reactor.py. ``add_evidence`` verifies on
the card (K2, K1 with the arena off): a device fault, marked where it
left the batch verifier (libs/devicefault), is not the peer's fault and
leaves ``receive`` for the switch to fail-stop the node; the peer is
stopped for bad evidence exactly as in the reference.
"""

from __future__ import annotations

import threading

from ..libs import devicefault
from ..p2p.base_reactor import ChannelDescriptor, Reactor
from ..types import serialization as ser
from ..types.evidence import EvidenceError
from .pool import EvidencePool

EVIDENCE_CHANNEL = 0x38


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__("evidence-reactor")
        self.pool = pool

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=EVIDENCE_CHANNEL, priority=6, send_queue_capacity=100
            )
        ]

    def add_peer(self, peer) -> None:
        if getattr(peer, "sim_driven", False):
            # simnet peers: the scheduler calls gossip_step on virtual
            # ticks instead of a clist-tailing thread per peer
            return
        threading.Thread(
            target=self._broadcast_routine,
            args=(peer,),
            name=f"evidence-bcast-{peer.id[:8]}",
            daemon=True,
        ).start()

    # virtual-ns interval after which still-pending evidence is offered
    # again (simnet links may silently eat a send — unlike TCP, where a
    # True send is delivered or the conn dies and a reconnect resets the
    # gossip cursor — so a one-shot offer could lose the only copy)
    REOFFER_NS = 1_000_000_000

    def gossip_step(self, peer, now_ns: int = 0) -> int:
        """Simnet tick: send every pending evidence this peer hasn't
        been offered recently (the clist cursor of the thread path,
        without blocking waits, plus periodic re-offers while the item
        stays pending).  Returns the number of items sent."""
        sent = peer.get("evidence_sent")
        if sent is None:
            sent = {}  # evidence hash -> virtual ns of last offer
            peer.set("evidence_sent", sent)
        n = 0
        for el in self.pool.evidence_list:
            if el.removed:
                continue
            ev = el.value
            h = ev.hash()
            last = sent.get(h)
            if last is not None and now_ns - last < self.REOFFER_NS:
                continue
            if peer.send(EVIDENCE_CHANNEL, ser.dumps(ev)):
                sent[h] = now_ns
                n += 1
        return n

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        try:
            ev = ser.loads(msg_bytes)
            self.pool.add_evidence(ev)
        except (EvidenceError, ValueError, KeyError) as e:
            if devicefault.is_fault(e):
                raise
            if self.switch is not None:
                self.switch.stop_and_remove_peer(peer, "bad evidence")

    def _broadcast_routine(self, peer) -> None:
        el = None
        while peer.is_running() and self.is_running():
            if el is None:
                el = self.pool.evidence_list.front_wait(timeout=0.2)
                if el is None:
                    continue
            if not el.removed:
                if not peer.send(EVIDENCE_CHANNEL, ser.dumps(el.value)):
                    continue
            nxt = el.next_wait(timeout=0.2)
            if nxt is not None:
                el = nxt
            elif el.removed:
                el = None
