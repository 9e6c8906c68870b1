"""The port's p2p layer against the JAX package's, on the CPU.

* X25519 on RFC 7748's vectors and on seeded scalars, equal to the
  reference's.
* ChaCha20-Poly1305: the native tier (native/chacha20poly1305.cpp, built
  by g++), the plain pure-Python construction, the reference's fallback
  and, where it is installed, the wheel give byte-equal output on seeded
  keys, nonces, aad and lengths 0 to 2,100; RFC 8439's AEAD vector; a
  flipped tag raises as the reference's does. Without the wheel
  new_chacha20poly1305 returns the native tier, and a broken native source
  raises NativeBuildError without running the pure-Python construction.
* SecretConnection: a port end and a reference end over a socketpair, in
  both directions, with the wheel and with it switched off
  (``_HAVE_CRYPTOGRAPHY``, as on a node without the wheel).
* MConnection writes the reference's bytes for one message sequence and
  reads them back into the same messages.
* NodeKey ids, the transport's network and id checks, and a port Switch
  exchanging messages with a reference Switch over localhost.
* flowrate.Monitor and the netstats counters on a fake clock.
"""

import random
import shutil
import socket
import threading
import time
import types

import pytest

from cometbft_tpu.crypto import aead as raead
from cometbft_tpu.crypto import keys as rkeys
from cometbft_tpu.crypto import x25519 as rx25519
from cometbft_tpu.libs import flowrate as rflowrate
from cometbft_tpu.libs import netstats as rnetstats
from cometbft_tpu import p2p as rp2p
from cometbft_tpu.p2p import base_reactor as rbase
from cometbft_tpu.p2p.conn import connection as rconn
from cometbft_tpu.p2p.conn import secret_connection as rsc
from cometbft_tpu_torch.crypto import aead as taead
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import x25519 as tx25519
from cometbft_tpu_torch.libs import flowrate as tflowrate
from cometbft_tpu_torch.libs import native_build
from cometbft_tpu_torch.libs import netstats as tnetstats
from cometbft_tpu_torch import p2p as tp2p
from cometbft_tpu_torch.p2p import base_reactor as tbase
from cometbft_tpu_torch.p2p import transport as ttransport
from cometbft_tpu_torch.p2p.conn import connection as tconn
from cometbft_tpu_torch.p2p.conn import secret_connection as tsc


def _seed(i: int) -> bytes:
    return random.Random(i).randbytes(32)


# ---------------------------------------------------------------- x25519

RFC7748 = [  # (scalar, u, output): RFC 7748 §5.2 and §6.1
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
     "09" + "00" * 31,
     "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"),
    ("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
     "09" + "00" * 31,
     "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"),
    ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
     "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
     "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"),
]


@pytest.mark.parametrize("k,u,out", RFC7748)
def test_x25519_rfc7748_vectors(k, u, out):
    k, u = bytes.fromhex(k), bytes.fromhex(u)
    assert tx25519.x25519(k, u).hex() == out
    assert rx25519.x25519(k, u).hex() == out


def test_x25519_seeded_scalars_equal_the_reference():
    rng = random.Random(7748)
    for _ in range(6):
        k, u = rng.randbytes(32), rng.randbytes(32)
        assert tx25519.x25519(k, u) == rx25519.x25519(k, u)
        assert tx25519.x25519_base(k) == rx25519.x25519_base(k)
    with pytest.raises(ValueError, match="32 bytes"):
        tx25519.x25519(bytes(31), bytes(32))


# ------------------------------------------------------ chacha20-poly1305

LENGTHS = (0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1023, 1024, 1028,
           1029, 2047, 2048, 2100)


def _wheel():
    try:
        from cryptography.hazmat.primitives.ciphers.aead import (
            ChaCha20Poly1305)
    except ImportError:
        return None
    return ChaCha20Poly1305


def test_native_plain_reference_and_wheel_are_byte_equal():
    rng = random.Random(8439)
    wheel = _wheel()
    lengths = list(LENGTHS) + [rng.randrange(0, 2101) for _ in range(6)]
    for n in lengths:
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        data = rng.randbytes(n)
        aad = rng.randbytes(rng.randrange(0, 40)) if n % 2 else None
        ciphers = [taead.ChaCha20Poly1305Native(key),
                   taead.ChaCha20Poly1305Fallback(key),
                   raead.ChaCha20Poly1305Fallback(key)]
        if wheel is not None:
            ciphers.append(wheel(key))
        sealed = {c.encrypt(nonce, data, aad) for c in ciphers}
        assert len(sealed) == 1, n
        (ct,) = sealed
        assert len(ct) == n + 16
        for c in ciphers[:3]:
            assert c.decrypt(nonce, ct, aad) == data


def test_rfc8439_aead_vector_and_a_flipped_tag():
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    native = taead.ChaCha20Poly1305Native(key)
    ct = native.encrypt(nonce, pt, aad)
    assert ct[:16].hex() == "d31a8d34648e60db7b86afbc53ef7ec2"
    assert ct[-16:].hex() == "1ae10b594f09e26a7e902ecbd0600691"
    assert native.decrypt(nonce, ct, aad) == pt
    for i in (0, len(ct) - 1, len(ct) - 16):
        bad = bytearray(ct)
        bad[i] ^= 1
        for c in (native, raead.ChaCha20Poly1305Fallback(key)):
            with pytest.raises(ValueError, match="poly1305 tag mismatch"):
                c.decrypt(nonce, bytes(bad), aad)
    with pytest.raises(ValueError, match="shorter than the poly1305 tag"):
        native.decrypt(nonce, ct[:15], aad)
    with pytest.raises(ValueError, match="32 bytes"):
        taead.ChaCha20Poly1305Native(bytes(31))


def test_xchacha_and_symmetric_boxes_open_across_packages():
    rng = random.Random(24)
    key, nonce, msg = rng.randbytes(32), rng.randbytes(24), rng.randbytes(300)
    box = taead.xchacha20poly1305_encrypt(key, nonce, msg, b"ad")
    assert box == raead.xchacha20poly1305_encrypt(key, nonce, msg, b"ad")
    assert raead.decrypt_symmetric(taead.encrypt_symmetric(msg, key),
                                   key) == msg
    text = taead.armor_encode(msg, "TENDERMINT PRIVATE KEY", {"kdf": "x"})
    assert text == raead.armor_encode(msg, "TENDERMINT PRIVATE KEY",
                                      {"kdf": "x"})
    assert taead.armor_decode(text) == raead.armor_decode(text)


def test_without_the_wheel_the_native_tier_seals_frames(monkeypatch):
    key = _seed(1)
    monkeypatch.setattr(taead, "_HAVE_CRYPTOGRAPHY", False)
    cipher = taead.new_chacha20poly1305(key)
    assert isinstance(cipher, taead.ChaCha20Poly1305Native)
    if _wheel() is not None:
        monkeypatch.setattr(taead, "_HAVE_CRYPTOGRAPHY", True)
        assert type(taead.new_chacha20poly1305(key)) is _wheel()


def test_a_broken_native_source_raises_and_nothing_falls_back(
        tmp_path, monkeypatch):
    src = tmp_path / "chacha20poly1305.cpp"
    shutil.copy(taead.NATIVE_SRC, src)
    with src.open("a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(taead, "NATIVE_SRC", src)
    monkeypatch.setattr(taead, "_lib", None)
    monkeypatch.setattr(taead, "_HAVE_CRYPTOGRAPHY", False)

    def never(*a, **k):
        raise AssertionError("the pure-Python construction ran")
    monkeypatch.setattr(taead.ChaCha20Poly1305Fallback, "encrypt", never)
    monkeypatch.setattr(taead, "_chacha20_block", never)
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+ failed"):
        taead.new_chacha20poly1305(_seed(2))
    assert taead._lib is None  # no failure remembered


# -------------------------------------------------------- secret connection


def _handshake(make_a, make_b):
    """Run two SecretConnection handshakes at once over a socketpair."""
    sa, sb = socket.socketpair()
    out, errs = {}, []

    def run(name, make, sock):
        try:
            out[name] = make(sock)
        except Exception as e:  # surfaced by the assert below
            errs.append(e)
    th = threading.Thread(target=run, args=("b", make_b, sb))
    th.start()
    run("a", make_a, sa)
    th.join(30)
    assert not errs, errs
    return out["a"], out["b"]


@pytest.mark.parametrize("wheel", [True, False], ids=["wheel", "no-wheel"])
def test_secret_connection_port_and_reference_ends(wheel, monkeypatch):
    if wheel and _wheel() is None:
        pytest.skip("the cryptography wheel is not installed here")
    if not wheel:
        for mod in (tsc, taead, rsc):
            monkeypatch.setattr(mod, "_HAVE_CRYPTOGRAPHY", False)
    tkey = tkeys.Ed25519PrivKey.from_seed(_seed(3))
    rkey = rkeys.Ed25519PrivKey.from_seed(_seed(4))
    rng = random.Random(5)
    for port_first in (True, False):
        makers = [lambda s: tsc.SecretConnection(s, tkey),
                  lambda s: rsc.SecretConnection(s, rkey)]
        if not port_first:
            makers.reverse()
        a, b = _handshake(*makers)
        port, ref = (a, b) if port_first else (b, a)
        try:
            assert port.remote_pub_key.bytes() == rkey.pub_key().bytes()
            assert ref.remote_pub_key.bytes() == tkey.pub_key().bytes()
            if not wheel:
                assert isinstance(port._send_aead,
                                  taead.ChaCha20Poly1305Native)
            for n in (1, 1024, 1025, 3000):
                msg = rng.randbytes(n)
                port.write(msg)
                assert ref.read_exact_msg(n) == msg
                msg = rng.randbytes(n)
                ref.write(msg)
                assert port.read_exact_msg(n) == msg
        finally:
            port.close()
            ref.close()


# ------------------------------------------------------------ mconnection


class _Wire:
    """The connection under an MConnection: records what it writes, and
    serves ``feed`` to its reads, then blocks until closed."""

    def __init__(self, feed=b""):
        self.written = bytearray()
        self.feed = bytes(feed)
        self.pos = 0
        self.cond = threading.Condition()
        self.closed = False

    def write(self, data):
        with self.cond:
            self.written += data
            self.cond.notify_all()
        return len(data)

    def read_exact_msg(self, n):
        with self.cond:
            if self.pos + n > len(self.feed):
                self.cond.wait_for(lambda: self.closed)
                raise EOFError("closed")
            out = self.feed[self.pos : self.pos + n]
            self.pos += n
            return out

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def wait_written(self, n):
        with self.cond:
            assert self.cond.wait_for(lambda: len(self.written) >= n, 10)


MESSAGES = [(0x20, b"a" * 10), (0x21, bytes(range(256)) * 12), (0x20, b""),
            (0x22, b"\x00\x01" * 600), (0x21, b"tail")]


def _packets_len(msg: bytes) -> int:
    n = max(1, -(-len(msg) // 1024))
    return 5 * n + len(msg)


@pytest.mark.parametrize("mod", [tconn, rconn], ids=["port", "reference"])
def test_mconnection_writes_and_reads_the_reference_bytes(mod):
    def wire_of(m):
        wire = _Wire()
        chans = [m.ChannelDescriptor(id=c, priority=p, send_queue_capacity=4)
                 for c, p in ((0x20, 6), (0x21, 10), (0x22, 7))]
        # no rate limit: the packets' cut then depends on nothing but the
        # messages (under one, on how much budget the clock has given)
        mc = m.MConnection(wire, chans, on_receive=lambda *a: None,
                           on_error=lambda e: None, peer_id="ab" * 20,
                           config=m.MConnConfig(send_rate=0, recv_rate=0))
        mc.start()
        try:
            total = 0
            for ch, msg in MESSAGES:
                assert mc.send(ch, msg)
                total += _packets_len(msg)
                wire.wait_written(total)
        finally:
            mc.stop()
        return bytes(wire.written)
    ours = wire_of(mod)
    assert ours == wire_of(rconn)

    got, done = [], threading.Event()
    wire = _Wire(ours)
    chans = [mod.ChannelDescriptor(id=c) for c in (0x20, 0x21, 0x22)]

    def on_receive(ch, msg):
        got.append((ch, msg))
        if len(got) == len(MESSAGES):
            done.set()
    mc = mod.MConnection(wire, chans, on_receive=on_receive,
                         on_error=lambda e: None)
    mc.start()
    try:
        assert done.wait(10)
    finally:
        mc.stop()
    assert got == MESSAGES


# ----------------------------------------------- node key, transport, switch


def test_node_key_ids_and_files_are_the_references(tmp_path):
    for i in range(3):
        seed = _seed(10 + i)
        tk = tp2p.NodeKey(tkeys.Ed25519PrivKey.from_seed(seed))
        rk = rp2p.NodeKey(rkeys.Ed25519PrivKey.from_seed(seed))
        assert tk.node_id == rk.node_id and len(tk.node_id) == 40
    path = str(tmp_path / "config" / "node_key.json")
    made = tp2p.NodeKey.load_or_generate(path)
    assert rp2p.NodeKey.load_or_generate(path).node_id == made.node_id
    assert tp2p.NodeKey.load_or_generate(path).node_id == made.node_id


def _transport(i, network, channels=b"\x30"):
    key = tp2p.NodeKey(tkeys.Ed25519PrivKey.from_seed(_seed(20 + i)))
    info = tp2p.NodeInfo(node_id=key.node_id, listen_addr="",
                         network=network, channels=channels)
    return tp2p.MultiplexTransport(key, info, handshake_timeout=10)


def test_transport_rejects_a_wrong_network_and_a_wrong_id():
    a = _transport(0, "net-a")
    a.listen("tcp://127.0.0.1:0")
    accepted = []

    def accept():
        while True:
            try:
                accepted.append(a.accept())
            except ttransport.TransportError:
                continue
            except OSError:
                return
    th = threading.Thread(target=accept, daemon=True)
    th.start()
    host_port = a.listen_addr[len("tcp://"):]
    try:
        with pytest.raises(ttransport.TransportError,
                           match="network mismatch"):
            _transport(1, "net-b").dial(a.listen_addr)
        wrong = _transport(2, "net-a")
        with pytest.raises(ttransport.TransportError, match="dialed"):
            wrong.dial(f"{'00' * 20}@{host_port}")
        up = _transport(3, "net-a").dial(
            f"{a.node_info.node_id}@{host_port}")
        assert up.node_info.node_id == a.node_info.node_id and up.outbound
        up.secret_conn.close()
    finally:
        a.close()
        th.join(5)
    assert all(u.node_info.network == "net-a" for u in accepted)


def _echo(base):
    class Echo(base.Reactor):
        def __init__(self):
            super().__init__("echo")
            self.got = []
            self.arrived = threading.Event()

        def get_channels(self):
            return [base.ChannelDescriptor(id=0x30, priority=5,
                                           send_queue_capacity=8)]

        def receive(self, ch_id, peer, msg):
            self.got.append((ch_id, msg))
            self.arrived.set()
    return Echo()


def _switch(p2p, keys, base, i):
    key = p2p.NodeKey(keys.Ed25519PrivKey.from_seed(_seed(30 + i)))
    echo = _echo(base)
    info = p2p.NodeInfo(node_id=key.node_id, listen_addr="", network="net",
                        other={"netstamp": 1})
    sw = p2p.Switch(p2p.MultiplexTransport(key, info))
    sw.add_reactor("ECHO", echo)
    info.channels = sw.channel_ids()
    sw.transport.listen("tcp://127.0.0.1:0")
    info.listen_addr = sw.transport.listen_addr
    return sw, echo


def test_port_switch_talks_to_a_reference_switch_over_localhost():
    tsw, techo = _switch(tp2p, tkeys, tbase, 0)
    rsw, recho = _switch(rp2p, rkeys, rbase, 1)
    tsw.start()
    rsw.start()
    try:
        rsw.dial_peers_async([f"{tsw.transport.node_info.node_id}@"
                              f"{tsw.transport.listen_addr[6:]}"])
        deadline = time.monotonic() + 20
        while not (tsw.peers() and rsw.peers()):
            assert time.monotonic() < deadline, "no connection"
            time.sleep(0.01)
        (tpeer,), (rpeer,) = tsw.peers(), rsw.peers()
        assert tpeer.stamping() and rpeer.stamping()
        assert not tpeer.outbound and rpeer.outbound
        assert tpeer.send(0x30, b"from the port")
        assert rpeer.send(0x30, b"from the reference" * 100)
        assert techo.arrived.wait(10) and recho.arrived.wait(10)
        assert techo.got == [(0x30, b"from the reference" * 100)]
        assert recho.got == [(0x30, b"from the port")]
    finally:
        tsw.stop()
        rsw.stop()


# -------------------------------------------------- flowrate and netstats


class _Clock:
    def __init__(self):
        self.t = 1000.0
        self.ns = 1_700_000_000_000_000_000

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s

    def time_ns(self):
        return self.ns


def test_flowrate_monitor_on_a_fake_clock_equals_the_reference(monkeypatch):
    clock = _Clock()
    for mod in (tflowrate, rflowrate):
        monkeypatch.setattr(mod, "time", clock)
    rng = random.Random(9)
    steps = [(rng.random() * 0.3, rng.randrange(0, 5000)) for _ in range(60)]
    seen = []
    for mod in (tflowrate, rflowrate):
        clock.t = 1000.0
        m = mod.Monitor(window=2.0)
        trace = []
        for dt, n in steps:
            clock.t += dt
            m.update(n)
            trace.append((m.rate(), m.total(), m.limit(4000, 50_000),
                          clock.t))
        seen.append(trace)
    assert seen[0] == seen[1]


def test_netstats_counters_and_stamps_on_a_fake_clock(monkeypatch):
    clock = _Clock()
    rows, stamps = [], []
    for mod in (tnetstats, rnetstats):
        monkeypatch.setattr(mod, "time", clock)
        clock.ns = 1_700_000_000_000_000_000
        clock.t = 50.0
        st = mod.ConnStats("cafe" * 10, [0x40, 0x20, 0x30], outbound=True)
        for i in range(20):
            clock.ns += 1_000_000 * (i + 1)
            slot = st.slots[(0x20, 0x30, 0x40)[i % 3]]
            st.note_sent(slot, 100 + i, i % 2 == 0)
            st.note_recv_bytes(slot, 50 + i)
            if i % 4 == 0:
                st.note_recv_msg(slot)
                st.note_depth(slot, i)
            if i % 7 == 0:
                st.note_queue_full(slot)
                st.note_try_full(slot)
            if i % 5 == 0:
                st.stamp_tx_wall[0] = clock.ns - 3_000_000
                st._note_skew_pair(clock.ns - 1_000_000 + 10_000 * i,
                                   clock.ns)
        clock.t += 3.0
        row = st.row()
        rows.append((row, st.last_recv_ns(), st.total_bytes(),
                     st.queue_full_total(mod.CONSENSUS_CHANNELS),
                     st.skew_row()))
        origin = mod.origin_prefix("ab12" * 10)
        raw = mod.make_stamp(origin, 7, clock.ns)
        stamps.append((origin, raw, mod.split_stamp(raw + b"payload"),
                       mod.split_stamp(b"unstamped"), mod.STAMP_LEN))
    assert rows[0] == rows[1]
    assert stamps[0] == stamps[1]
    assert tnetstats.STAMPED_CHANNELS == rnetstats.STAMPED_CHANNELS
    assert tnetstats.PHASES == rnetstats.PHASES


def test_netstats_sample_and_propagation_equal_the_reference(monkeypatch):
    from cometbft_tpu.libs import metrics as rmetrics
    from cometbft_tpu_torch.libs import metrics as tmetrics

    clock = _Clock()
    out = []
    for mod, metrics in ((tnetstats, tmetrics), (rnetstats, rmetrics)):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "_CONNS", [])
        monkeypatch.setattr(mod, "_enabled", True)
        mod.reset()
        m = metrics.NodeMetrics()
        metrics.push_node_metrics(m)
        try:
            fake = types.SimpleNamespace(
                channels={}, send_monitor=None, recv_monitor=None)
            st = mod.ConnStats("beef" * 10, [0x20, 0x22], mconn=fake)
            mod.register(st)
            st.note_sent(st.slots[0x22], 500, True)
            st.note_depth(st.slots[0x20], 3)
            st.note_queue_full(st.slots[0x22])
            lags = []
            for i in range(12):
                clock.ns = 1_700_000_000_000_000_000 + i * 10**9
                mod.set_current_stamp(("ab" * 8, i, clock.ns - 1_000_000 *
                                       (i + 1)), st)
                mod.observe_propagation(("prevote", "commit", "tx")[i % 3],
                                        i)
                mod.clear_current_stamp()
                lags.append(mod.gossip_lag_s())
            out.append((mod.sample(m), lags, mod.propagation_p99(m),
                        mod.consensus_queue_full_total(),
                        sorted(mod.skew_table())))
            mod.deregister(st)
        finally:
            metrics.pop_node_metrics(m)
            mod.reset()
    assert out[0] == out[1]
