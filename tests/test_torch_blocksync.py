"""The port's blocksync against the JAX package's, on the CPU.

* BlockPool: the port's and the reference's pools through one scripted
  run on a fake clock (requests, timeouts, bans, a slow peer, redo,
  unsolicited blocks, caught-up) must send the same requests, report the
  same peers and hold the same state after every step.
* The blocksync messages cross the two packages' codecs byte for byte.
* A four-validator chain, built by chip_smoke's NetNode and net_chain on
  the CPU, caught up by a port follower over localhost TCP: its stores
  equal the server's at every height. Served first by a byzantine server
  whose block 3 carries a spoiled LastCommit lane, the follower redoes
  heights 2 and 3 and stops that server, as the reference does.
* A marked device fault inside verify_commit_light fail-stops the
  follower through on_fatal: no height is redone and no peer punished.
"""

import dataclasses
import threading
import time
import types

import pytest

from cometbft_tpu.blocksync import messages as rmsgs
from cometbft_tpu.blocksync import pool as rpool
from cometbft_tpu.libs import flowrate as rflowrate
from cometbft_tpu.types import serialization as rser
from cometbft_tpu_torch.blocksync import messages as tmsgs
from cometbft_tpu_torch.blocksync import pool as tpool
from cometbft_tpu_torch.blocksync import reactor as treactor
from cometbft_tpu_torch.libs import devicefault
from cometbft_tpu_torch.libs import flowrate as tflowrate
from cometbft_tpu_torch.types import serialization as tser
from test_torch_smoke import _chip_smoke


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _blk(h):
    return types.SimpleNamespace(header=types.SimpleNamespace(height=h))


def test_pool_scripted_run_equals_the_reference(monkeypatch):
    clock = _Clock()
    for mod in (tflowrate, rflowrate):
        monkeypatch.setattr(mod, "time", clock)
    assert (tpool.REQUEST_WINDOW, tpool.REQUEST_TIMEOUT,
            tpool.MIN_RECV_RATE, tpool.RATE_GRACE) == (
        rpool.REQUEST_WINDOW, rpool.REQUEST_TIMEOUT, rpool.MIN_RECV_RATE,
        rpool.RATE_GRACE) == (20, 15.0, 7680, 2.0)

    def run(mod):
        clock.t = 100.0
        sent, errors, states = [], [], []
        p = mod.BlockPool(3, lambda h, pid: sent.append((h, pid)),
                          lambda pid, r: errors.append((pid, r)),
                          now_fn=clock.monotonic)

        def snap(tag, out=None):
            b1, _, b2 = p.peek_two_blocks()
            states.append((tag, out, p.height, p.max_peer_height,
                           p.is_caught_up(),
                           b1 and b1.header.height, b2 and b2.header.height,
                           sorted((h, r.peer_id, r.block is not None,
                                   sorted(r.banned))
                                  for h, r in p.requesters.items()),
                           sorted((q.id, q.num_pending, q.timeout_count)
                                  for q in p.peers.values()),
                           list(sent), list(errors)))
        snap("empty")
        p.set_peer_range("a", 1, 30)
        p.set_peer_range("b", 5, 12)
        p.make_requests()
        snap("requests")
        owner = {h: pid for h, pid in sent}
        for h in (3, 4, 6):
            snap("add", p.add_block(owner[h], _blk(h), size=40_000))
        snap("unsolicited", p.add_block("b" if owner[5] == "a" else "a",
                                        _blk(5)))
        snap("late", p.add_block(owner[3], _blk(3)))
        p.pop_request()
        snap("pop")
        clock.t += 16.0
        p.make_requests()
        snap("timeouts")
        for _ in range(2):
            clock.t += 16.0
            p.make_requests()
        snap("three timeouts")
        p.redo_request(4)
        snap("redo")
        p.set_peer_range("c", 1, 40)
        p.make_requests()
        snap("new peer")
        clock.t += 3.0
        pending = [h for h, r in sorted(p.requesters.items())
                   if r.peer_id == "c" and r.block is None]
        p.add_block("c", _blk(pending[0]), size=100)
        clock.t += 1.0
        p.make_requests()
        snap("slow peer")
        p.remove_peer("a")
        p.remove_peer("b")
        snap("removed")
        p.set_peer_range("d", 1, p.height + 1)
        snap("caught up")
        return states
    assert run(tpool) == run(rpool)


def test_messages_cross_the_codecs_byte_for_byte():
    cs = _chip_smoke()
    keys, secret, sign = _small_set(cs, 4)
    node = cs.ConsensusNode(cs.net_genesis(keys), None,
                            cs.consensus_config(True), device="cpu")
    try:
        chain, _ = cs.net_chain(node, sign, secret)
    finally:
        node.stop()
    blk, _, commit = chain[2]
    ext = cs.chain_extended(commit)
    port = [tmsgs.StatusRequestMessage(),
            tmsgs.StatusResponseMessage(height=9, base=2),
            tmsgs.BlockRequestMessage(7),
            tmsgs.NoBlockResponseMessage(height=11),
            tmsgs.BlockResponseMessage(block=blk),
            tmsgs.BlockResponseMessage(block=blk, ext_commit=ext)]
    for msg in port:
        raw = tser.dumps(msg)
        ref = rser.loads(raw)
        assert type(ref).__module__ == rmsgs.__name__
        assert rser.dumps(ref) == raw
        back = tser.loads(rser.dumps(ref))
        assert type(back) is type(msg) and tser.dumps(back) == raw


def _small_set(cs, n):
    """chip_smoke's net key set cut to ``n`` validators (light check at
    2n/3 + 1 lanes), signed in this process."""
    saved = cs.NET_VALIDATORS
    cs.NET_VALIDATORS = n
    try:
        return cs.net_key_set(None)
    finally:
        cs.NET_VALIDATORS = saved


def _wait(cond, what, timeout=60.0, nodes=()):
    deadline = time.monotonic() + timeout
    while not cond():
        for n in nodes:
            assert not n.fatal, f"{what}: {n.fatal}"
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.01)


@pytest.fixture
def net(tmp_path, monkeypatch):
    """A four-validator chain of four heights (4 kvstore txs each) on an
    honest server and a byzantine copy (block 3's LastCommit spoiled at
    lane 1), both serving, and a fresh follower with blocksync on; the
    nodes stopped after the test."""
    cs = _chip_smoke()
    for name, value in (("NET_HEIGHTS", 4), ("NET_TXS", 4),
                        ("NET_TAMPERED", 1)):
        monkeypatch.setattr(cs, name, value)
    keys, secret, sign = _small_set(cs, 4)
    genesis = cs.net_genesis(keys)
    cfg = cs.consensus_config(burst=True)
    nodes = []

    def node(name, i, **kw):
        n = cs.NetNode(genesis, None, cfg, cs._seed(b"bs-test", i),
                       tmp_path / name, device="cpu", **kw)
        nodes.append(n)
        return n
    try:
        honest = node("honest", 0, consensus=False)
        byz = node("byzantine", 1, consensus=False)
        chain, states = cs.net_chain(honest, sign, secret)
        cs.byzantine_store(byz, chain)
        follower = node("follower", 2, block_sync=True)
        for n in (honest, byz, follower):
            n.start()
        yield types.SimpleNamespace(cs=cs, honest=honest, byz=byz,
                                    follower=follower, chain=chain,
                                    states=states)
    finally:
        for n in nodes:
            n.stop()


def _stores_equal(follower, honest, top):
    """The follower's block and state stores hold the server's blocks,
    metas, commits, FinalizeBlock responses and validator sets at every
    height up to ``top``."""
    fb, hb = follower.block_store, honest.block_store
    for h in range(1, top + 1):
        assert tser.dumps(fb.load_block(h)) == tser.dumps(hb.load_block(h))
        assert fb.load_block_meta(h) == hb.load_block_meta(h)
        if h < top:  # the commit of h comes with block h + 1
            assert tser.dumps(fb.load_block_commit(h)) == tser.dumps(
                hb.load_block_commit(h))
        assert (follower.state_store.load_finalize_block_response(h)
                == honest.state_store.load_finalize_block_response(h))
        assert (follower.state_store.load_validators(h).hash()
                == honest.state_store.load_validators(h).hash())


def test_follower_catches_up_over_tcp_with_the_servers_stores(net):
    fol = net.follower
    fol.switch.dial_peers_async([net.honest.addr])
    bsr = fol.blocksync_reactor
    _wait(bsr.synced.is_set, "catch-up", nodes=(fol,))
    _wait(fol.cs.is_running, "consensus start", nodes=(fol,))
    assert bsr._n_synced == 3 and fol.block_store.height() == 3
    assert not fol.cs.do_wal_catchup
    _stores_equal(fol, net.honest, 3)
    assert bsr.state.app_hash == net.states[3].app_hash
    assert fol.state_store.load().app_hash == net.states[3].app_hash


def test_a_spoiled_last_commit_is_redone_and_its_server_stopped(net):
    fol = net.follower
    bsr = fol.blocksync_reactor
    redone, stopped = [], []
    real_redo = bsr.pool.redo_request
    bsr.pool.redo_request = lambda h: (redone.append(h), real_redo(h))[1]
    real_stop = fol.switch.stop_and_remove_peer

    def stop(peer, reason):
        stopped.append((peer.id, str(reason)))
        return real_stop(peer, reason)
    fol.switch.stop_and_remove_peer = stop
    fol.switch.dial_peers_async([net.byz.addr])
    _wait(lambda: stopped, "the byzantine server stopped", nodes=(fol,))
    assert redone[:2] == [2, 3]
    assert stopped[0] == (net.byz.node_key.node_id, "bad block 2")
    assert fol.block_store.height() == 1  # block 1 checked by block 2
    fol.switch.dial_peers_async([net.honest.addr])
    _wait(bsr.synced.is_set, "catch-up from the honest server",
          nodes=(fol,))
    _stores_equal(fol, net.honest, 3)
    assert not fol.fatal


def test_a_device_fault_in_the_light_check_fail_stops_the_follower(
        monkeypatch):
    """K2's launch raises below the batch verifier's boundary (the light
    check's three lanes sent to the device by a cut of 2): the pool
    routine hands the marked fault to on_fatal; nothing is redone and no
    peer stopped. An unmarked verification failure on the same pool is
    the peer's, as in the reference."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    keys, secret, sign = _small_set(cs, 4)
    genesis = cs.net_genesis(keys)
    server = cs.ConsensusNode(genesis, None, cs.consensus_config(True),
                              device="cpu")
    try:
        monkeypatch.setattr(cs, "NET_HEIGHTS", 3)
        monkeypatch.setattr(cs, "NET_TXS", 2)
        chain, _ = cs.net_chain(server, sign, secret)
    finally:
        server.stop()

    def follower():
        node = cs.ConsensusNode(genesis, None, cs.consensus_config(True),
                                device="cpu")
        bsr = treactor.BlocksyncReactor(node.cs.state, node.exe,
                                        node.block_store, True,
                                        device="cpu")
        calls = []
        peer = types.SimpleNamespace(id="peer", try_send=lambda ch, m: True)
        bsr.switch = types.SimpleNamespace(
            get_peer=lambda pid: peer,
            stop_and_remove_peer=lambda p, r: calls.append((p.id, str(r))),
            try_broadcast=lambda ch, msg: None)
        bsr.pool.set_peer_range("peer", 1, 3)
        bsr.pool.make_requests()
        for h in (1, 2, 3):
            assert bsr.pool.add_block("peer", chain[h][0])
        return node, bsr, calls

    def launch_fails(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(batch, "HOST_BATCH_THRESHOLD", 2)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    monkeypatch.setattr(ov, "verify_rsk_async", launch_fails)
    monkeypatch.setattr(ov, "verify_bytes_async", launch_fails)
    node, bsr, calls = follower()
    redone = []
    real_redo = bsr.pool.redo_request
    bsr.pool.redo_request = lambda h: (redone.append(h), real_redo(h))[1]
    fatal = []
    bsr.on_fatal = fatal.append
    try:
        th = threading.Thread(target=bsr._pool_routine)
        th.start()
        th.join(30)
        assert not th.is_alive()
    finally:
        node.stop()
    assert len(fatal) == 1 and devicefault.is_fault(fatal[0])
    assert redone == [] and calls == [] and bsr._n_synced == 0

    # the same blocks with block 3's LastCommit spoiled and the device
    # working: the peer's fault, heights 2 and 3 redone, the peer punished
    monkeypatch.undo()
    chain[3] = (dataclasses.replace(chain[3][0], last_commit=cs.
                                    _tampered_commit(chain[3][0]
                                                     .last_commit, 0)),
                None, None)
    node, bsr, calls = follower()
    redone = []
    real_redo = bsr.pool.redo_request
    bsr.pool.redo_request = lambda h: (redone.append(h), real_redo(h))[1]
    bsr.on_fatal = fatal.append
    try:
        for _ in range(3):
            bsr._pool_step(time.monotonic())
    finally:
        node.stop()
    assert redone == [2, 3] and bsr._n_synced == 1
    # (a real switch has dropped the peer before the second report)
    assert calls[0] == ("peer", "bad block 2") and len(fatal) == 1
