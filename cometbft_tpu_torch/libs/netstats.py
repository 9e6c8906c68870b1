"""Network-plane telemetry: per-peer/per-channel stats + message provenance.

The reference CometBFT ships a rich p2p metrics surface
(p2p/metrics.go: per-channel ``message_{send,receive}_bytes_total``,
``peer_pending_send_bytes``) and the tpu-bft committee-consensus
measurements (PAPERS.md, arxiv 2302.00418) show vote dissemination +
verification dominating latency at scale — yet until this layer the p2p
plane here was nearly blind: one ``p2p_peers`` gauge and two byte
counters.  Three pillars close that gap:

* **Per-peer/per-channel stats** (:class:`ConnStats`): every live
  ``MConnection`` registers one stats block — per-channel message/byte
  counters, send-queue depth + high-watermark, queue-full drop tallies,
  last-send/recv timestamps — stored in preallocated ``array('q')``
  columns indexed by a channel→slot map built at connection setup.  The
  record path is **lock-free by design**: the send columns are written
  only by the connection's single send routine, the recv columns only
  by its recv routine, so no mutex ever joins the wire path (the one
  lock here, ``libs.netstats._mtx``, serializes only connection
  (de)registration).

* **Cross-node message provenance**: peers that advertise the
  ``netstamp`` capability in their NodeInfo prepend a fixed 23-byte
  stamp (magic + version + origin node-id prefix + per-peer monotonic
  seq + wall-clock hint) to every message on the :data:`STAMPED_CHANNELS`
  enum.  Stamping is **negotiated**, never sniffed blind: a sender
  stamps only toward peers that advertised the capability, so an
  unstamped (older) peer sees byte-identical wire traffic and an
  advertising peer's messages are always stamped — no payload can be
  confused with a stamp.  On receive the stamp is stripped, parked in a
  thread-local for the reactor dispatch (the recv routine calls the
  reactor synchronously), and the wall hint yields one-hop gossip lag:
  the consensus reactor attributes it per phase into
  ``p2p_propagation_seconds{phase}`` histograms and ``EV_GOSSIP``
  flight-recorder events.  The wall hint crosses node clocks — exact
  for in-process multi-node nets and benches (one clock), a skew-bound
  estimate between real hosts.

* **Scrape-time aggregation** (:func:`sample`, :func:`snapshot`):
  per-channel queue depth/high-watermark gauges, queue-full counters,
  flowrate send/recv rates per peer (a capped **top-K by traffic plus
  an ``other`` bucket** keeps the ``peer`` label cardinality bounded —
  peer label values are 10-char node-id prefixes, never the full
  unbounded string), and the ``/debug/net`` JSON table served by the
  pprof server.

Design constraints (same tier as libs/health — this layer is on for
every running node):

* **Allocation-free when disabled.**  Every hot entry point is one
  module-flag check and an immediate return.
* **Allocation-light when enabled.**  Enabled recording performs only
  C-level array stores and small-int arithmetic; nothing is retained
  per packet.

Port of cometbft_tpu/libs/netstats.py, line for line.

Knobs (registered in config.ENV_KNOBS):
``COMETBFT_TPU_NET`` (auto: on while a node runs; 1 force; 0 off),
``COMETBFT_TPU_NET_STAMP`` (provenance stamping; default on — still
negotiated per peer), ``COMETBFT_TPU_NET_TOPK`` (peers exported with
their own ``peer`` label value before aggregating into ``other``).
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
from array import array

from . import metrics as libmetrics
from . import sync as libsync
from . import trace as libtrace

_ENV_NET = "COMETBFT_TPU_NET"
_ENV_STAMP = "COMETBFT_TPU_NET_STAMP"
_ENV_TOPK = "COMETBFT_TPU_NET_TOPK"

_ON_VALUES = ("1", "on", "true", "yes")
_OFF_VALUES = ("0", "off", "false", "no")

DEFAULT_TOPK = 8
# recent one-hop gossip-lag window (ring of wall-hint deltas, seconds)
_LAG_RING = 512

# Channels that carry provenance stamps when both ends negotiated the
# capability. A fixed enum — never derived from peer input — so the
# ``chID`` label space stays bounded. The mempool channel is included:
# negotiation (never content sniffing) makes raw-tx payloads safe.
CONSENSUS_CHANNELS = frozenset({0x20, 0x21, 0x22, 0x23})
STAMPED_CHANNELS = frozenset({0x20, 0x21, 0x22, 0x23, 0x30, 0x40})

# -- provenance stamp wire format ---------------------------------------
# magic(2) | version u8 | origin node-id prefix (8 raw bytes = 16 hex
# chars) | per-peer monotonic seq u32 | wall-clock hint u64 (ns).
# The magic pair can never open a ser.dumps JSON payload, and stamping
# is negotiated anyway — the prefix check is a consistency assertion,
# not a discriminator.
STAMP_MAGIC = b"\xc5\x9d"
STAMP_VERSION = 1
_STAMP_FMT = "<2sB8sIQ"
STAMP_LEN = struct.calcsize(_STAMP_FMT)  # 23 bytes

NODEINFO_STAMP_KEY = "netstamp"

# propagation phase codes (EV_GOSSIP ``a`` column; names are the
# ``phase`` label of p2p_propagation_seconds).  The tail three are
# channel-grain phases the simnet delivery plane records (one EV_GOSSIP
# per delivered message, attributed by channel: 0x20/0x23 state,
# 0x22 vote, 0x38 evidence) — appended so existing codes never move.
PHASES = (
    "proposal", "block_part", "prevote", "precommit", "commit",
    "block", "tx", "state", "vote", "evidence",
)
PHASE_CODES = {name: i + 1 for i, name in enumerate(PHASES)}
PHASE_NAMES = {i + 1: name for i, name in enumerate(PHASES)}


def _env_mode() -> str:
    v = os.environ.get(_ENV_NET, "").lower()
    if v in _ON_VALUES:
        return "on"
    if v in _OFF_VALUES:
        return "off"
    return "auto"


def stamping_wanted() -> bool:
    """Whether this process advertises + applies provenance stamps
    (still negotiated per peer).  ``COMETBFT_TPU_NET_STAMP=0`` opts out
    of stamping alone; ``COMETBFT_TPU_NET=0`` kills it with the rest of
    the layer — a dark node must not pay the per-message stamp copy
    for telemetry nobody consumes."""
    if _env_mode() == "off":
        return False
    return (
        os.environ.get(_ENV_STAMP, "").lower() not in _OFF_VALUES
    )


def top_k() -> int:
    try:
        return max(1, int(os.environ.get(_ENV_TOPK, "")))
    except ValueError:
        return DEFAULT_TOPK


_mode = _env_mode()
_enabled: bool = _mode == "on"
_acquirers = 0

_mtx = libsync.Mutex("libs.netstats._mtx")  # connection registry only
_CONNS: list["ConnStats"] = []

# thread-local parking spot for the stamp of the message currently
# being dispatched to a reactor (the recv routine calls the reactor
# synchronously, so the slot is scoped to one dispatch)
_tls = threading.local()

# recent gossip-lag ring (seconds, cross-conn): preallocated, slot
# reservation via one GIL-atomic count — same posture as libs/health
_lag = array("d", [0.0] * _LAG_RING)
_lag_seq = itertools.count()
_lag_n = array("q", [0])


def enabled() -> bool:
    """The one check hot paths make before recording."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def acquire() -> None:
    """Reference-counted enable for node lifecycles (the devstats /
    health pattern): on for every running node unless
    ``COMETBFT_TPU_NET=0`` pins it off."""
    global _acquirers, _enabled
    if _env_mode() == "off":
        return
    _acquirers += 1
    _enabled = True


def release() -> None:
    global _acquirers, _enabled
    _acquirers = max(0, _acquirers - 1)
    if _acquirers == 0 and _env_mode() != "on":
        _enabled = False
        # drop the gossip-lag window with the last holder: a stopped
        # node's p99 must not leak into the next node's SLI (or a later
        # process-wide gossip_lag_s() read)
        reset()


def reset() -> None:
    """Drop the gossip-lag window (tests, bench bursts). Registered
    connections are untouched — they deregister with their owners."""
    global _lag_seq
    for i in range(len(_lag)):
        _lag[i] = 0.0
    _lag_seq = itertools.count()
    _lag_n[0] = 0


# ------------------------------------------------------ per-conn stats

# ConnStats column indices (per channel slot)
_C_MSGS_SENT = 0
_C_BYTES_SENT = 1
_C_MSGS_RECV = 2
_C_BYTES_RECV = 3
_C_QUEUE_FULL = 4  # MConnection.send timeout drops
_C_TRY_FULL = 5  # try_send immediate-full misses (normal backpressure)
_C_QUEUE_HWM = 6  # send-queue depth high-watermark
_C_LAST_SEND = 7  # time_ns of the last packet sent
_C_LAST_RECV = 8  # time_ns of the last message received
_N_COLS = 9


class ConnStats:
    """One connection's per-channel telemetry block.

    Columns are parallel ``array('q')`` vectors indexed by a
    channel→slot map frozen at construction.  Send columns are written
    only by the connection's send routine, recv columns only by its
    recv routine — single-writer, so the record path takes no lock.
    ``queue_full``/``try_full`` are written by arbitrary caller
    threads; a lost increment under that rare race costs one tally,
    never a corrupt structure (the libs/health notice posture).
    """

    __slots__ = (
        "peer_id", "outbound", "created_mono", "slots", "ch_ids",
        "_cols", "stamp_tx_seq", "stamp_rx_seq", "stamp_rx_lag_ns",
        "stamp_tx_wall", "skew",
        "_channels", "_send_monitor", "_recv_monitor",
    )

    def __init__(self, peer_id: str, ch_ids, mconn=None, outbound=False):
        self.peer_id = (peer_id or "")[:10]  # short id: bounded label
        self.outbound = outbound
        self.created_mono = time.monotonic()
        self.ch_ids = tuple(sorted(ch_ids))
        self.slots = {ch: i for i, ch in enumerate(self.ch_ids)}
        self._cols = [
            array("q", [0] * len(self.ch_ids)) for _ in range(_N_COLS)
        ]
        # provenance bookkeeping (send routine / recv routine writers)
        self.stamp_tx_seq = array("q", [0])
        self.stamp_rx_seq = array("q", [0])
        self.stamp_rx_lag_ns = array("q", [0])
        # clock-skew estimator state: wall ns of our last stamped send
        # (written by whichever thread stamps; one slot, GIL-atomic)
        # and the best NTP-style round-trip pair so far — see
        # _note_skew_pair for the estimate's semantics.
        # skew slots: [off_ns, bound_ns, rt_ns, pairs, lb_ns, lb_set]
        # where lb_ns is the always-sound lower bound on the offset
        # (max over inbound stamps of t2 - t3: a message cannot arrive
        # before it was sent, whatever the clocks say)
        self.stamp_tx_wall = array("q", [0])
        self.skew = array("q", [0, 0, 0, 0, 0, 0])
        self._channels = mconn.channels if mconn is not None else {}
        self._send_monitor = mconn.send_monitor if mconn is not None else None
        self._recv_monitor = mconn.recv_monitor if mconn is not None else None

    # -- record paths (single-writer per direction, lock-free) ----------

    def note_sent(self, slot: int, nbytes: int, eof: bool) -> None:
        cols = self._cols
        cols[_C_BYTES_SENT][slot] += nbytes
        cols[_C_LAST_SEND][slot] = time.time_ns()
        if eof:
            cols[_C_MSGS_SENT][slot] += 1

    def note_recv_msg(self, slot: int) -> None:
        self._cols[_C_MSGS_RECV][slot] += 1

    def note_recv_bytes(self, slot: int, nbytes: int) -> None:
        cols = self._cols
        cols[_C_BYTES_RECV][slot] += nbytes
        cols[_C_LAST_RECV][slot] = time.time_ns()

    def note_queue_full(self, slot: int) -> None:
        self._cols[_C_QUEUE_FULL][slot] += 1

    def note_try_full(self, slot: int) -> None:
        self._cols[_C_TRY_FULL][slot] += 1

    def note_depth(self, slot: int, depth: int) -> None:
        hwm = self._cols[_C_QUEUE_HWM]
        if depth > hwm[slot]:
            hwm[slot] = depth

    # -- read paths (scrape only) ---------------------------------------

    def queue_depth(self, ch_id: int) -> int:
        ch = self._channels.get(ch_id)
        if ch is None:
            return 0
        # racy len() read of a list: scrape-time best effort, no lock
        return len(ch._queue) + (1 if ch.sending is not None else 0)

    def total_bytes(self) -> int:
        return sum(self._cols[_C_BYTES_SENT]) + sum(
            self._cols[_C_BYTES_RECV]
        )

    def last_recv_ns(self) -> int:
        """time_ns of the most recent received message across channels
        (0 = nothing yet) — the suspicion scorer's staleness signal."""
        col = self._cols[_C_LAST_RECV]
        latest = 0
        for i in range(len(col)):
            if col[i] > latest:
                latest = col[i]
        return latest

    def last_lag_ns(self) -> int:
        """One-hop lag of the most recent stamped inbound message."""
        return self.stamp_rx_lag_ns[0]

    def queue_full_total(self, channels=None) -> int:
        col = self._cols[_C_QUEUE_FULL]
        if channels is None:
            return sum(col)
        # plain loop, no genexpr: the saturation watchdog calls this
        # from HealthMonitor._check, whose no-trip path is pinned
        # allocation-free — a generator frame caught in a GC cycle
        # would read as a retained allocation there
        total = 0
        for ch, i in self.slots.items():
            if ch in channels:
                total += col[i]
        return total

    def _note_skew_pair(self, peer_wall_ns: int, now_ns: int) -> None:
        """Fold one (our last stamped send t1, peer stamp t2, our
        receive t3) triple into the NTP-style skew estimate.

        offset = t2 - (t1 + t3)/2 with a ±rt/2 bound (rt = t3 - t1) —
        valid when the paired inbound was emitted AFTER our send, the
        NTP causality assumption.  Under continuous bidirectional
        gossip a CROSSED message (emitted before our send, arriving
        just after it) can produce an artificially tiny rt and an
        offset understated by up to a one-way delay, and a naive
        minimum-rt rule would lock exactly those pairs in.  Two
        defenses: (1) every inbound stamp yields the always-sound
        lower bound ``offset >= t2 - t3`` (a message cannot arrive
        before it was sent — no causality assumption at all), tracked
        as the running max; (2) a candidate pair whose offset+bound
        falls BELOW that sound bound is provably crossed and is
        rejected, and a stored pair a later sound bound invalidates is
        evicted so the next consistent pair replaces it.  Among the
        consistent pairs, minimum rt gives the tightest bound.  Runs
        on the recv routine; ``stamp_tx_wall`` is written by the
        sender side (one-slot cross-thread read, GIL-atomic, the
        ConnStats lost-increment posture)."""
        sk = self.skew
        # sound lower bound from EVERY inbound stamp (t2 - t3)
        lb = peer_wall_ns - now_ns
        if not sk[5] or lb > sk[4]:
            sk[4] = lb
            sk[5] = 1
            # a tighter sound bound can expose the stored pair as
            # crossed after the fact: evict it
            if sk[2] and sk[0] + sk[1] < sk[4]:
                sk[0] = sk[1] = sk[2] = 0
        t1 = self.stamp_tx_wall[0]
        if t1 == 0:
            return
        rt = now_ns - t1
        if rt < 0:
            return  # racing writer moved t1 past our read; skip
        sk[3] += 1
        off = peer_wall_ns - (t1 + now_ns) // 2
        bound = max(1, rt // 2)
        if off + bound < sk[4]:
            return  # provably crossed pairing: offset range excludes
            # the sound lower bound
        if sk[2] == 0 or rt < sk[2]:
            sk[2] = rt
            sk[0] = off
            sk[1] = bound

    def skew_row(self) -> dict | None:
        """The peer's clock-skew estimate, or None before any
        round-trip pair completed."""
        sk = self.skew
        if sk[3] == 0 or sk[2] == 0:
            return None
        return {
            "offset_s": round(sk[0] / 1e9, 9),
            "bound_s": round(sk[1] / 1e9, 9),
            "rt_s": round(sk[2] / 1e9, 9),
            "pairs": sk[3],
            # the causality-free floor: offset >= this, whatever the
            # message interleaving was
            "floor_s": round(sk[4] / 1e9, 9) if sk[5] else None,
        }

    def rates(self) -> tuple[float, float]:
        sm, rm = self._send_monitor, self._recv_monitor
        return (
            sm.rate() if sm is not None else 0.0,
            rm.rate() if rm is not None else 0.0,
        )

    def channel_row(self, ch_id: int) -> dict:
        i = self.slots[ch_id]
        cols = self._cols
        now = time.time_ns()

        def age(ns: int):
            return round((now - ns) / 1e9, 3) if ns else None

        ch = self._channels.get(ch_id)
        return {
            "chID": f"{ch_id:#04x}",
            "msgs_sent": cols[_C_MSGS_SENT][i],
            "bytes_sent": cols[_C_BYTES_SENT][i],
            "msgs_recv": cols[_C_MSGS_RECV][i],
            "bytes_recv": cols[_C_BYTES_RECV][i],
            "queue_depth": self.queue_depth(ch_id),
            "queue_capacity": (
                ch.desc.send_queue_capacity if ch is not None else None
            ),
            "queue_highwater": cols[_C_QUEUE_HWM][i],
            "send_queue_full": cols[_C_QUEUE_FULL][i],
            "try_send_full": cols[_C_TRY_FULL][i],
            "last_send_age_s": age(cols[_C_LAST_SEND][i]),
            "last_recv_age_s": age(cols[_C_LAST_RECV][i]),
        }

    def row(self) -> dict:
        send_rate, recv_rate = self.rates()
        return {
            "peer": self.peer_id or "?",
            "outbound": self.outbound,
            "age_s": round(time.monotonic() - self.created_mono, 3),
            "send_rate_bps": round(send_rate, 1),
            "recv_rate_bps": round(recv_rate, 1),
            "stamp": {
                "tx_seq": self.stamp_tx_seq[0],
                "rx_seq": self.stamp_rx_seq[0],
                "rx_lag_last_s": round(self.stamp_rx_lag_ns[0] / 1e9, 6),
                "clock_skew": self.skew_row(),
            },
            "channels": [
                self.channel_row(ch) for ch in self.ch_ids
            ],
        }


def register(stats: ConnStats) -> None:
    """Add a connection's stats block (connection start — not hot)."""
    with _mtx:
        _CONNS.append(stats)


def deregister(stats: ConnStats) -> None:
    with _mtx:
        for i in range(len(_CONNS) - 1, -1, -1):
            if _CONNS[i] is stats:
                del _CONNS[i]
                return


def connections() -> tuple:
    """Lock-free snapshot of the registered connections (scrape paths
    must never touch ``_mtx`` — same posture as health.active_monitor)."""
    return tuple(_CONNS)


def skew_table() -> dict:
    """Per-peer clock-skew estimates (tightest-bound connection wins
    when a peer has several) — exported with the flight ring so the
    cross-node timeline merge can tag live cross-node edges with a
    measured bound instead of a warning."""
    out: dict[str, dict] = {}
    for c in connections():
        row = c.skew_row()
        if row is None or not c.peer_id:
            continue
        prev = out.get(c.peer_id)
        if prev is None or row["bound_s"] < prev["bound_s"]:
            out[c.peer_id] = row
    return out


def consensus_queue_full_total() -> int:
    """Total MConnection.send timeout drops on the consensus channels —
    the saturated-send-queue watchdog's signal (libs/health)."""
    total = 0
    for c in connections():
        total += c.queue_full_total(CONSENSUS_CHANNELS)
    return total


# -------------------------------------------------- provenance stamps


def make_stamp(origin8: bytes, seq: int, wall_ns: int | None = None) -> bytes:
    """Encode one provenance stamp (origin prefix must be 8 bytes)."""
    return struct.pack(
        _STAMP_FMT,
        STAMP_MAGIC,
        STAMP_VERSION,
        origin8,
        seq & 0xFFFFFFFF,
        wall_ns if wall_ns is not None else time.time_ns(),
    )


def split_stamp(msg: bytes) -> tuple[tuple | None, bytes]:
    """``(stamp, payload)`` — stamp is ``(origin_hex, seq, wall_ns)``
    or None when the message carries no stamp (wire-compat path)."""
    if len(msg) < STAMP_LEN or not msg.startswith(STAMP_MAGIC):
        return None, msg
    magic, ver, origin, seq, wall = struct.unpack_from(_STAMP_FMT, msg)
    if ver != STAMP_VERSION:
        # a future stamp version we cannot decode: drop the stamp,
        # keep the payload (forward compat)
        return None, msg[STAMP_LEN:]
    return (origin.hex(), seq, wall), msg[STAMP_LEN:]


def origin_prefix(node_id: str) -> bytes:
    """8-byte origin prefix from a (hex) node id; tolerant of exotic
    ids so a misconfigured moniker can't crash the wire path."""
    try:
        raw = bytes.fromhex(node_id[:16])
    except ValueError:
        raw = node_id.encode()[:8]
    return raw.ljust(8, b"\0")


def set_current_stamp(stamp, stats: ConnStats | None = None) -> None:
    """Park ``stamp`` for the reactor dispatch running on this thread
    (the recv routine calls reactors synchronously)."""
    _tls.stamp = stamp
    if stamp is not None and stats is not None:
        stats.stamp_rx_seq[0] = stamp[1]
        now = time.time_ns()
        lag = now - stamp[2]
        stats.stamp_rx_lag_ns[0] = lag if lag > 0 else 0
        # every inbound stamp that follows one of our stamped sends is
        # a round-trip pair for the per-peer clock-skew estimator
        stats._note_skew_pair(stamp[2], now)


def current_stamp():
    """The provenance stamp of the message being dispatched on this
    thread, or None (unstamped peer / non-p2p path)."""
    return getattr(_tls, "stamp", None)


def clear_current_stamp() -> None:
    # store only when something is parked: a no-op clear must not even
    # materialize the thread-local mapping (the disabled wire path
    # calls this and is pinned allocation-free by the tracemalloc guard)
    if getattr(_tls, "stamp", None) is not None:
        _tls.stamp = None


def observe_propagation(phase: str, height: int = 0) -> None:
    """Attribute the current message's one-hop propagation lag to a
    consensus ``phase``: Prometheus histogram + EV_GOSSIP flight event
    + the gossip-lag window the health SLI reads.  One flag check and
    out when the layer is off or the message carried no stamp."""
    if not _enabled:
        return
    stamp = getattr(_tls, "stamp", None)
    if stamp is None:
        return
    lag_ns = time.time_ns() - stamp[2]
    if lag_ns < 0:
        lag_ns = 0  # cross-host clock skew: clamp, don't go negative
    lag_s = lag_ns / 1e9
    libmetrics.node_metrics().p2p_propagation.labels(phase).observe(lag_s)
    i = next(_lag_seq) % _LAG_RING
    _lag[i] = lag_s
    if _lag_n[0] < _LAG_RING:
        _lag_n[0] = min(_LAG_RING, _lag_n[0] + 1)
    from . import health as libhealth

    libhealth.record(
        libhealth.EV_GOSSIP,
        height,
        a=PHASE_CODES.get(phase, 0),
        b=lag_ns,
    )
    if libtrace.enabled():
        libtrace.event(
            "p2p.gossip",
            phase=phase,
            height=height,
            origin=stamp[0],
            seq=stamp[1],
            lag_ns=lag_ns,
        )


def propagation_p99(metrics=None) -> dict:
    """Per-phase p99 of the one-hop propagation histogram, through the
    shared promql-style estimator (libmetrics.quantile_from_buckets —
    the same math health.sample and the budget plane use).  Scrape-time
    only; phases with no observations yet are omitted."""
    m = metrics if metrics is not None else libmetrics.node_metrics()
    fam = m.p2p_propagation
    with fam._mtx:
        children = list(fam._children.items())
    out: dict[str, float] = {}
    for key, child in children:
        counts = list(child._counts)
        if not any(counts):
            continue
        out[key[0]] = round(
            libmetrics.quantile_from_buckets(child.buckets, counts, 0.99),
            6,
        )
    return out


def gossip_lag_s(q: float = 0.99) -> float:
    """Quantile of the recent one-hop gossip-lag window (seconds);
    0.0 when nothing stamped arrived yet.  Scrape-time only."""
    n = min(_lag_n[0], _LAG_RING)
    if n <= 0:
        return 0.0
    vals = sorted(_lag[i] for i in range(n))
    return vals[min(n - 1, int(q * n))]


# ------------------------------------------------ scrape-time sampling


def sample(metrics=None) -> dict:
    """Pull-time collector: aggregate the registered connections into
    the per-channel queue gauges and the capped top-K ``peer`` rate
    gauges of ``metrics`` (or the process-wide top registry).  Stale
    peer series are removed so the ``peer`` label stays bounded by
    K + 1 (``other``) regardless of churn."""
    m = metrics if metrics is not None else libmetrics.node_metrics()
    conns = connections()
    depth: dict[int, int] = {}
    hwm: dict[int, int] = {}
    for c in conns:
        for ch, i in c.slots.items():
            depth[ch] = depth.get(ch, 0) + c.queue_depth(ch)
            hwm[ch] = max(hwm.get(ch, 0), c._cols[_C_QUEUE_HWM][i])
    live_ch = {f"{ch:#04x}" for ch in depth}
    for ch in depth:
        lbl = f"{ch:#04x}"
        m.p2p_send_queue_depth.labels(lbl).set(depth[ch])
        m.p2p_send_queue_hwm.labels(lbl).set(hwm[ch])
    # channels no live connection carries: drop the series, or a
    # backlog alert built on the depth gauge never clears after the
    # saturated peer disconnects
    for gauge in (m.p2p_send_queue_depth, m.p2p_send_queue_hwm):
        for key in list(gauge._children):
            if key[0] not in live_ch:
                gauge.remove(*key)
    # top-K peers by total traffic; the rest fold into "other"
    k = top_k()
    ranked = sorted(conns, key=lambda c: c.total_bytes(), reverse=True)
    live: set[str] = set()
    other_send = other_recv = 0.0
    for idx, c in enumerate(ranked):
        send_rate, recv_rate = c.rates()
        if idx < k and c.peer_id:
            live.add(c.peer_id)
            m.p2p_peer_rate.labels(c.peer_id, "send").set(send_rate)
            m.p2p_peer_rate.labels(c.peer_id, "recv").set(recv_rate)
            # measured clock-skew bound to the stamped top-K peers
            # (netstamp round-trip pairs; no pair yet = no series)
            srow = c.skew_row()
            if srow is not None:
                m.p2p_peer_clock_skew.labels(c.peer_id).set(
                    srow["offset_s"]
                )
                m.p2p_peer_clock_skew_bound.labels(c.peer_id).set(
                    srow["bound_s"]
                )
        else:
            other_send += send_rate
            other_recv += recv_rate
    m.p2p_peer_rate.labels("other", "send").set(other_send)
    m.p2p_peer_rate.labels("other", "recv").set(other_recv)
    # drop series for departed / demoted peers: bounded cardinality
    for key in list(m.p2p_peer_rate._children):
        if key[0] != "other" and key[0] not in live:
            m.p2p_peer_rate.remove(*key)
    for gauge in (m.p2p_peer_clock_skew, m.p2p_peer_clock_skew_bound):
        for key in list(gauge._children):
            if key[0] not in live:
                gauge.remove(*key)
    # (health_gossip_lag_seconds is set by libhealth.sample — the SLI
    # engine owns it; setting it here too would sort the lag window
    # twice per scrape)
    return {
        "connections": len(conns),
        "queue_depth": {f"{ch:#04x}": d for ch, d in depth.items()},
        "queue_highwater": {f"{ch:#04x}": h for ch, h in hwm.items()},
    }


def snapshot() -> dict:
    """The ``/debug/net`` body and the ``net.json`` bundle artifact:
    per-peer table (channels, queue depths, rates, last-msg ages,
    stamp state) + the process-wide gossip-lag window."""
    conns = connections()
    return {
        "enabled": _enabled,
        "stamping": stamping_wanted(),
        "top_k": top_k(),
        "connections": len(conns),
        "gossip_lag_p50_s": round(gossip_lag_s(0.50), 6),
        "gossip_lag_p99_s": round(gossip_lag_s(0.99), 6),
        "propagation_p99_s": propagation_p99(),
        "consensus_send_queue_full": consensus_queue_full_total(),
        "clock_skew": skew_table(),
        "peers": [c.row() for c in conns],
    }


def debug_net_json() -> str:
    return json.dumps(snapshot(), default=str)
