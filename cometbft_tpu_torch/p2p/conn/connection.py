"""Multiplexed connection (reference: p2p/conn/connection.go:80-921).

N logical byte-ID channels over one (secret) connection. Each channel has
a bounded send queue and a priority; the send routine repeatedly picks the
channel with the least recently-sent/priority ratio (connection.go:522)
and emits one packet (≤1024B payload). The recv routine reassembles
packets until EOF and hands complete messages to ``on_receive``.
Ping/pong keep-alive kills dead peers; flowrate throttles both directions.

Packet wire format (binary, little-endian):
``0x01`` ping | ``0x02`` pong | ``0x03 channel_id:u8 eof:u8 len:u16 data``.
"""

from __future__ import annotations

import struct

from ...libs import metrics as libmetrics
from ...libs import netstats as libnetstats
from ...libs import trace as libtrace
import threading
from ...libs import sync as libsync
import time
from dataclasses import dataclass

from ...libs.flowrate import Monitor
from ...libs.service import BaseService

_PKT_PING = 1
_PKT_PONG = 2
_PKT_MSG = 3

MAX_PACKET_PAYLOAD = 1024
DEFAULT_SEND_RATE = 5_120_000
DEFAULT_RECV_RATE = 5_120_000
DEFAULT_SEND_QUEUE_CAPACITY = 1
DEFAULT_RECV_MESSAGE_CAPACITY = 22020096  # block part ceiling
PING_INTERVAL = 60.0
PONG_TIMEOUT = 45.0
FLUSH_THROTTLE = 0.1


@dataclass(slots=True)
class MConnConfig:
    send_rate: int = DEFAULT_SEND_RATE
    recv_rate: int = DEFAULT_RECV_RATE
    max_packet_msg_payload_size: int = MAX_PACKET_PAYLOAD
    flush_throttle: float = FLUSH_THROTTLE
    ping_interval: float = PING_INTERVAL
    pong_timeout: float = PONG_TIMEOUT


@dataclass(slots=True)
class ChannelDescriptor:
    id: int
    priority: int = 1
    send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY
    recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self._mtx = libsync.Mutex("p2p.conn.connection._mtx")
        self._queue: list[bytes] = []
        self._not_full = libsync.Condition(self._mtx)
        self.sending: bytes | None = None
        self.sent_pos = 0
        self.recently_sent = 0  # exponentially decayed
        self.recving = b""

    def enqueue(self, msg: bytes, timeout: float) -> bool:
        with self._not_full:
            if not self._not_full.wait_for(
                lambda: len(self._queue) < self.desc.send_queue_capacity,
                timeout,
            ):
                return False
            self._queue.append(msg)
            return True

    def try_enqueue(self, msg: bytes) -> bool:
        with self._mtx:
            if len(self._queue) >= self.desc.send_queue_capacity:
                return False
            self._queue.append(msg)
            return True

    def has_data(self) -> bool:
        with self._mtx:
            return self.sending is not None or bool(self._queue)

    def next_packet(self, max_payload: int) -> tuple[bytes, bool] | None:
        with self._not_full:
            if self.sending is None:
                if not self._queue:
                    return None
                self.sending = self._queue.pop(0)
                self.sent_pos = 0
                self._not_full.notify()
            chunk = self.sending[self.sent_pos : self.sent_pos + max_payload]
            self.sent_pos += len(chunk)
            eof = self.sent_pos >= len(self.sending)
            if eof:
                self.sending = None
                self.sent_pos = 0
            self.recently_sent += len(chunk)
            return chunk, eof


class MConnection(BaseService):
    def __init__(
        self,
        conn,  # SecretConnection or socket-like with write/read_exact_msg
        channels: list[ChannelDescriptor],
        on_receive,  # f(channel_id, msg_bytes)
        on_error,  # f(exception)
        config: MConnConfig | None = None,
        peer_id: str = "",
        outbound: bool = False,
        origin_id: int = 0,
        logger=None,
    ):
        super().__init__("mconnection", logger)
        self.conn = conn
        # flight-ring origin of the node that OWNS this connection: the
        # recv routine dispatches reactors synchronously, so rows they
        # record (p2p.gossip) are attributed to this node (libs/health)
        self.origin_id = origin_id
        self.config = config or MConnConfig()
        self.channels = {d.id: _Channel(d) for d in channels}
        # Labeled-counter children resolved ONCE per channel: the wire
        # loops must not pay a registry lookup + label format per packet.
        # Bound at connection setup — connections are created after node
        # boot, when the node registry is installed.
        m = libmetrics.node_metrics()
        self._send_ctr = {
            d.id: m.p2p_send_bytes.labels(f"{d.id:#04x}") for d in channels
        }
        self._recv_ctr = {
            d.id: m.p2p_recv_bytes.labels(f"{d.id:#04x}") for d in channels
        }
        self._msg_send_ctr = {
            d.id: m.p2p_msgs_sent.labels(f"{d.id:#04x}") for d in channels
        }
        self._msg_recv_ctr = {
            d.id: m.p2p_msgs_recv.labels(f"{d.id:#04x}") for d in channels
        }
        self._drop_ctr = {
            d.id: m.p2p_send_queue_full.labels(f"{d.id:#04x}")
            for d in channels
        }
        self.on_receive = on_receive
        self.on_error = on_error
        self.send_monitor = Monitor()
        self.recv_monitor = Monitor()
        # Per-peer/per-channel stats block (libs/netstats): constructed
        # unconditionally (setup path, not hot), registered for the
        # connection's lifetime in on_start; the per-packet record
        # calls below are one enabled() flag check when the layer is
        # off.
        self.stats = libnetstats.ConnStats(
            peer_id, [d.id for d in channels], self, outbound=outbound
        )
        self._send_signal = threading.Event()
        self._pong_pending = threading.Event()
        self._last_pong = time.monotonic()
        self._write_mtx = libsync.Mutex("p2p.conn.connection._write_mtx")

    # -- API ---------------------------------------------------------------

    def send(self, ch_id: int, msg: bytes, timeout: float = 10.0) -> bool:
        """Queue a message; blocks up to ``timeout`` when the channel queue
        is full (connection.go Send).  A timeout is a DROP the caller
        must handle — it is logged, counted in
        ``p2p_send_queue_full_total{chID}`` and trace-attributed, never
        a silent False."""
        ch = self.channels.get(ch_id)
        if ch is None or not self.is_running():
            return False
        ok = ch.enqueue(msg, timeout)
        if ok:
            self._send_signal.set()
            if libnetstats.enabled():
                self.stats.note_depth(
                    self.stats.slots[ch_id], len(ch._queue)
                )
        else:
            self._note_drop(ch_id, len(msg), timeout)
        return ok

    def _note_drop(self, ch_id: int, nbytes: int, timeout: float) -> None:
        """Account one send() timeout on a full bounded queue."""
        ctr = self._drop_ctr.get(ch_id)
        if ctr is not None:
            ctr.inc()
        if libnetstats.enabled():
            self.stats.note_queue_full(self.stats.slots[ch_id])
        if libtrace.enabled():
            libtrace.event(
                "p2p.drop",
                ch=ch_id,
                bytes=nbytes,
                timeout_s=timeout,
                peer=self.stats.peer_id,
            )
        if self.logger is not None:
            self.logger.debug(
                "send queue full; message dropped",
                ch=f"{ch_id:#04x}",
                bytes=nbytes,
                peer=self.stats.peer_id,
                timeout_s=timeout,
            )

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        ch = self.channels.get(ch_id)
        if ch is None or not self.is_running():
            return False
        ok = ch.try_enqueue(msg)
        if ok:
            self._send_signal.set()
            if libnetstats.enabled():
                self.stats.note_depth(
                    self.stats.slots[ch_id], len(ch._queue)
                )
        elif libnetstats.enabled():
            # an immediate-full miss is normal backpressure (broadcast
            # paths retry) — tallied per channel, surfaced in
            # /debug/net, not in the drop counter
            self.stats.note_try_full(self.stats.slots[ch_id])
        return ok

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._last_pong = time.monotonic()
        libnetstats.register(self.stats)
        threading.Thread(
            target=self._routine_entry, args=(self._send_routine,),
            name="mconn-send", daemon=True,
        ).start()
        threading.Thread(
            target=self._routine_entry, args=(self._recv_routine,),
            name="mconn-recv", daemon=True,
        ).start()

    def _routine_entry(self, routine) -> None:
        if self.origin_id:
            from ...libs import health as libhealth

            libhealth.set_thread_origin(self.origin_id)
        routine()

    def on_stop(self) -> None:
        libnetstats.deregister(self.stats)
        self._send_signal.set()
        try:
            self.conn.close()
        except Exception:
            pass

    def _fail(self, err: Exception) -> None:
        if self.is_running():
            try:
                self.stop()
            except Exception:
                pass
            self.on_error(err)

    # -- send side (connection.go:424 sendRoutine) -------------------------

    def _send_routine(self) -> None:
        last_ping = time.monotonic()
        while not self.quit_event().is_set():
            self._send_signal.wait(timeout=0.05)
            self._send_signal.clear()
            try:
                now = time.monotonic()
                if now - last_ping >= self.config.ping_interval:
                    self._write_packet(struct.pack("<B", _PKT_PING))
                    last_ping = now
                if (
                    self._pong_pending.is_set()
                ):
                    self._write_packet(struct.pack("<B", _PKT_PONG))
                    self._pong_pending.clear()
                # Drain packets while any channel has data.
                while not self.quit_event().is_set():
                    if not self._send_some_packets():
                        break
                if (
                    now - self._last_pong
                    > self.config.ping_interval + self.config.pong_timeout
                ):
                    raise TimeoutError("pong timeout")
            except Exception as e:
                self._fail(e)
                return

    def _send_some_packets(self, batch: int = 10) -> bool:
        sent_any = False
        for _ in range(batch):
            if not self._send_one_packet():
                return sent_any
            sent_any = True
        return sent_any

    def _send_one_packet(self) -> bool:
        """Pick the channel with least recently_sent/priority
        (connection.go:522 sendPacketMsg)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        if best is None:
            # decay all counters while idle
            for ch in self.channels.values():
                ch.recently_sent = int(ch.recently_sent * 0.8)
            return False
        # Ask for budget BEFORE cutting the packet so the allowance bounds
        # the payload (limit() also sleeps when over rate).
        allowed = self.send_monitor.limit(
            self.config.max_packet_msg_payload_size + 5, self.config.send_rate
        )
        max_payload = min(
            self.config.max_packet_msg_payload_size, max(1, allowed - 5)
        )
        pkt = best.next_packet(max_payload)
        if pkt is None:
            return False
        chunk, eof = pkt
        # frame: type u8 | channel u8 | eof u8 | len u16 | data
        self._write_packet(
            struct.pack(
                "<BBBH", _PKT_MSG, best.desc.id, 1 if eof else 0, len(chunk)
            )
            + chunk
        )
        self.send_monitor.update(len(chunk) + 5)
        self._send_ctr[best.desc.id].inc(len(chunk) + 5)
        if eof:
            self._msg_send_ctr[best.desc.id].inc()
        if libnetstats.enabled():
            self.stats.note_sent(
                self.stats.slots[best.desc.id], len(chunk) + 5, eof
            )
        if libtrace.enabled():
            libtrace.event(
                "p2p.send", ch=best.desc.id, bytes=len(chunk) + 5, eof=eof
            )
        return True

    def _write_packet(self, data: bytes) -> None:
        with self._write_mtx:  # cometlint: disable=CLNT009 -- the write mutex exists to serialize whole frames onto the socket
            self.conn.write(data)

    # -- recv side (connection.go:562 recvRoutine) -------------------------

    def _read_exact(self, n: int) -> bytes:
        if hasattr(self.conn, "read_exact_msg"):
            return self.conn.read_exact_msg(n)
        out = b""
        while len(out) < n:
            chunk = self.conn.read(n - len(out))
            if not chunk:
                raise EOFError("connection closed")
            out += chunk
        return out

    def _recv_routine(self) -> None:
        while not self.quit_event().is_set():
            try:
                (ptype,) = struct.unpack("<B", self._read_exact(1))
                if ptype == _PKT_PING:
                    self._pong_pending.set()
                    self._send_signal.set()
                    continue
                if ptype == _PKT_PONG:
                    self._last_pong = time.monotonic()
                    continue
                if ptype != _PKT_MSG:
                    raise ValueError(f"unknown packet type {ptype}")
                ch_id, eof, length = struct.unpack("<BBH", self._read_exact(4))
                data = self._read_exact(length) if length else b""
                ctr = self._recv_ctr.get(ch_id)
                if ctr is not None:
                    ctr.inc(length + 5)
                if libnetstats.enabled():
                    slot = self.stats.slots.get(ch_id)
                    if slot is not None:
                        self.stats.note_recv_bytes(slot, length + 5)
                self.recv_monitor.limit(length + 5, self.config.recv_rate)
                self.recv_monitor.update(length + 5)
                ch = self.channels.get(ch_id)
                if ch is None:
                    raise ValueError(f"unknown channel {ch_id:#x}")
                ch.recving += data
                if len(ch.recving) > ch.desc.recv_message_capacity:
                    raise ValueError(
                        f"recv msg exceeds capacity on channel {ch_id:#x}"
                    )
                if eof:
                    msg, ch.recving = ch.recving, b""
                    self._msg_recv_ctr[ch_id].inc()
                    if libnetstats.enabled():
                        self.stats.note_recv_msg(self.stats.slots[ch_id])
                    if libtrace.enabled():
                        libtrace.event(
                            "p2p.recv", ch=ch_id, bytes=len(msg)
                        )
                    self.on_receive(ch_id, msg)
            except Exception as e:
                if not self.quit_event().is_set():
                    self._fail(e)
                return
