"""The port's consensus engine (cometbft_tpu_torch/consensus) against the
JAX package's, on the same seeded inputs, exactly; the port's in-process
net, restart and fail-stop paths on their own.

The step-for-step case builds one node in each package: a 4-validator
genesis, the node holding one key, MemDB stores, a WAL, a CListMempool,
an EvidencePool and an inline CommitPipeline, the FSM sim-driven on one
virtual clock that only the test moves. The test plays the other
three validators, feeds both nodes the same proposals, parts and votes
and pumps each with process_pending; the port runs with device="cpu".
"""

import dataclasses
import importlib
import importlib.util
import os
import time
from pathlib import Path

import pytest

from cometbft_tpu_torch import convert

CHAIN_ID = "consensus-chain"
T0 = 1_700_000_000_000_000_000
N_VALS = 4
NODE = 1  # the node's validator index: it proposes height 2
HEIGHTS = 3


class Clock:
    """The FSM's time seam: a wall clock and a monotonic clock that move
    only when the test moves them."""

    def __init__(self):
        self.now_ns = T0 + 10**9

    def time_ns(self) -> int:
        return self.now_ns

    def monotonic(self) -> float:
        return self.now_ns / 1e9


class Ticker:
    """The sim ticker's surface: one pending timeout, a later (H, R, S)
    replaces it; the test fires it."""

    def __init__(self):
        self.pending = None
        self.running = False

    def start(self):
        self.running = True

    def stop(self):
        self.running = False

    def is_running(self):
        return self.running

    def schedule_timeout(self, ti):
        p = self.pending
        if p is not None and (ti.height, ti.round, ti.step) < (
                p.height, p.round, p.step):
            return
        self.pending = ti


def pkg_module(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def make_signers(pkg):
    """(genesis, the MockPVs in the validator set's order)."""
    t = pkg_module(pkg, "types")
    keys = pkg_module(pkg, "crypto.keys")
    pvs = [t.MockPV(keys.Ed25519PrivKey.from_seed(bytes([i + 1]) * 32))
           for i in range(N_VALS)]
    genesis = t.GenesisDoc(
        chain_id=CHAIN_ID, genesis_time_ns=T0,
        validators=[t.GenesisValidator(pub_key=pv.get_pub_key(), power=10)
                    for pv in pvs])
    by = {bytes(pv.get_pub_key().address()): pv for pv in pvs}
    return genesis, [by[v.address] for v in
                     genesis.validator_set().validators]


class SimNode:
    """One package's node for the step-for-step run."""

    def __init__(self, pkg, wal_path):
        m = lambda name: pkg_module(pkg, name)  # noqa: E731
        self.m = m
        self.dev = {"device": "cpu"} if pkg == "cometbft_tpu_torch" else {}
        self.genesis, self.pvs = make_signers(pkg)
        dbm = m("libs.db")
        cfg = m("config").test_config()
        self.app = m("abci.kvstore").KVStoreApplication()
        self.conns = m("proxy").AppConns(
            m("proxy").local_client_creator(self.app))
        self.conns.start()
        st = m("state")
        self.state_store = st.Store(dbm.MemDB())
        self.block_store = m("store").BlockStore(dbm.MemDB())
        state = st.make_genesis_state(self.genesis)
        self.state_store.save(state)
        self.mempool = m("mempool").CListMempool(
            cfg.mempool, self.conns.mempool, **self.dev)
        self.evidence = m("evidence").EvidencePool(
            dbm.MemDB(), self.state_store, self.block_store, **self.dev)
        self.exe = st.BlockExecutor(
            self.state_store, self.conns.consensus, mempool=self.mempool,
            evidence_pool=self.evidence, block_store=self.block_store,
            **self.dev)
        self.wal = m("consensus.wal").WAL(wal_path)
        self.clock = Clock()
        self.cs = m("consensus").ConsensusState(
            cfg.consensus, state, self.exe, self.block_store,
            tx_notifier=self.mempool, evidence_pool=self.evidence,
            wal=self.wal, clock=self.clock, **self.dev)
        self.cs.sim_driven = True
        self.cs.ticker = Ticker()
        self.cs.set_priv_validator(self.pvs[NODE])
        self.fatal = []
        self.cs.on_fatal = self.fatal.append
        pipe = m("consensus.pipeline").CommitPipeline(
            self.exe, self.cs.wal, on_fatal=self.fatal.append, **self.dev)
        pipe.enabled = pipe.inline = pipe.spec_enabled = True
        pipe.note_base(0)
        self.exe.prune_gate = pipe.durable_height
        self.cs.pipeline = pipe
        self.sent = []  # the node's own messages, as the codec writes them
        orig = self.cs._send_internal

        def send(msg, orig=orig):
            self.sent.append(self.ser().dumps(msg))
            orig(msg)
        self.cs._send_internal = send

    def ser(self):
        return self.m("types.serialization")

    def pump(self):
        self.cs.process_pending()
        assert not self.fatal, self.fatal

    def fire_new_height(self) -> bool:
        """Fire the pending round-start timeout (NEW_HEIGHT), if any."""
        ti = self.cs.ticker.pending
        if ti is None or ti.step != 1:
            return False
        self.cs.ticker.pending = None
        self.cs._queue.put(("timeout", ti))
        self.pump()
        return True

    def close(self):
        self.cs.stop()
        self.conns.stop()
        self.wal.close()


def _votes(node, h, msg_type, block_id, skip, tamper=None):
    """The other validators' votes for ``block_id``, signed."""
    t = node.m("types")
    out = []
    for i, (v, pv) in enumerate(zip(node.cs.state.validators.validators,
                                    node.pvs)):
        if i == skip:
            continue
        vote = t.Vote(msg_type=msg_type, height=h, round=0,
                      block_id=block_id,
                      timestamp_ns=node.clock.now_ns + 11 * i,
                      validator_address=v.address, validator_index=i)
        pv.sign_vote(CHAIN_ID, vote, sign_extension=False)
        if i == tamper:
            vote = dataclasses.replace(vote, signature=bytes(
                [vote.signature[0] ^ 1]) + vote.signature[1:])
        out.append(vote)
    return out


def _drive(node, txs_of):
    """Heights 1..HEIGHTS on ``node``: what the test saw at each step."""
    t = node.m("types")
    seen = []
    for h in range(1, HEIGHTS + 1):
        for tx in txs_of(h):
            node.mempool.check_tx(tx)
        node.clock.now_ns += 10**9
        node.fire_new_height()
        rs = node.cs.get_round_state()
        assert rs.height == h and rs.round == 0
        proposer = rs.validators.get_proposer()
        if proposer.address != bytes(node.pvs[NODE].get_pub_key().address()):
            with node.cs._mtx:
                last = node.cs.rs.last_commit
            blk = node.exe.create_proposal_block(
                h, node.cs.state, None if last is None
                else last.make_extended_commit(), proposer.address,
                time_ns=node.clock.now_ns)
            parts = t.PartSet.from_data(node.ser().dumps(blk))
            bid = t.BlockID(blk.hash(), parts.header)
            prop = t.Proposal(height=h, round=0, pol_round=-1, block_id=bid,
                              timestamp_ns=node.clock.now_ns)
            idx, _ = rs.validators.get_by_address(proposer.address)
            node.pvs[idx].sign_proposal(CHAIN_ID, prop)
            node.cs.set_proposal_from_peer(prop, "peer")
            node.pump()
            for part in parts.parts:
                node.cs.add_block_part_from_peer(h, 0, part, "peer")
            node.pump()
        rs = node.cs.get_round_state()
        bid = rs.proposal.block_id
        seen.append(("proposal", h, node.ser().dumps(rs.proposal)))
        node.clock.now_ns += 10**8
        for v in _votes(node, h, t.PREVOTE_TYPE, bid, NODE,
                        tamper=2 if h == 2 else None):
            node.cs.add_vote_from_peer(v, "peer")
        node.pump()
        seen.append(("step", h, node.cs.get_round_state().step.name))
        node.clock.now_ns += 10**8
        for v in _votes(node, h, t.PRECOMMIT_TYPE, bid, NODE):
            node.cs.add_vote_from_peer(v, "peer")
        node.pump()
        seen.append(("stored", h, node.block_store.height(),
                     node.cs.get_round_state().height))
    return seen


def _txs(h):
    return [b"h%d-k%d=%d" % (h, i, h * 100 + i) for i in range(6)]


def _record(node):
    ser = node.ser()
    enc = node.m("state").Store._encode_state
    blocks = [ser.dumps(node.block_store.load_block(h))
              for h in range(1, HEIGHTS + 1)]
    commits = [ser.dumps(node.block_store.load_block_commit(h))
               for h in range(1, HEIGHTS)]
    return {
        "blocks": blocks, "commits": commits,
        "seen_commit": ser.dumps(node.block_store.load_seen_commit()),
        "app_hash": node.app.app_hash,
        "state": enc(node.state_store.load()),
        "fsm_state": enc(node.cs.state),
        "sent": node.sent,
        "wal": [ser.dumps(m) for m in node.wal.iter_messages()],
        "mempool": node.mempool.size(),
    }


def test_engine_step_for_step_equals_the_reference(tmp_path):
    nodes = (SimNode("cometbft_tpu", str(tmp_path / "ref" / "wal")),
             SimNode("cometbft_tpu_torch", str(tmp_path / "port" / "wal")))
    try:
        seen = []
        for node in nodes:
            node.cs.start()
            node.pump()
            seen.append(_drive(node, _txs))
        assert seen[1] == seen[0]
        ref, port = (_record(n) for n in nodes)
        for key in ref:
            assert port[key] == ref[key], key
        assert ref["mempool"] == 0 and len(ref["blocks"]) == HEIGHTS
        assert nodes[1].block_store.height() == HEIGHTS
        assert nodes[1].cs.get_round_state().height == HEIGHTS + 1
        # the node proposed height 2 itself and signed every round's votes
        sent = ref["sent"]
        assert sum(b'"ProposalMessage"' in m for m in sent) == 1
        assert sum(b'"VoteMessage"' in m for m in sent) == 2 * HEIGHTS
    finally:
        for node in nodes:
            node.close()


# -- the WAL ---------------------------------------------------------------


def _wal_messages(pkg):
    """A WAL's worth of messages of each kind, built in ``pkg``."""
    t = pkg_module(pkg, "types")
    w = pkg_module(pkg, "consensus.wal")
    msgs = pkg_module(pkg, "consensus.messages")
    genesis, pvs = make_signers(pkg)
    bid = t.BlockID(b"\x11" * 32, t.PartSetHeader(1, b"\x22" * 32))
    vote = t.Vote(msg_type=t.PREVOTE_TYPE, height=3, round=1, block_id=bid,
                  timestamp_ns=T0 + 5,
                  validator_address=genesis.validator_set()
                  .validators[0].address, validator_index=0)
    pvs[0].sign_vote(CHAIN_ID, vote, sign_extension=False)
    prop = t.Proposal(height=3, round=1, pol_round=0, block_id=bid,
                      timestamp_ns=T0 + 6)
    pvs[0].sign_proposal(CHAIN_ID, prop)
    part = t.PartSet.from_data(b"\x33" * 100_000, 65_536).get_part(1)
    return [
        w.MsgInfo(msgs.VoteMessage(vote), "peer-a"),
        w.MsgInfo(msgs.ProposalMessage(prop), ""),
        w.MsgInfo(msgs.BlockPartMessage(3, 1, part), "peer-b"),
        w.TimeoutInfo(0.25, 3, 1, 4),
        w.EndHeightMessage(3),
    ]


def test_wal_frames_equal_the_reference(tmp_path):
    from cometbft_tpu.consensus.wal import WAL as RWAL
    from cometbft_tpu_torch.consensus.wal import WAL as TWAL
    from cometbft_tpu_torch.types import serialization as tser

    ref_msgs = _wal_messages("cometbft_tpu")
    port_msgs = [convert.message_from(m) for m in ref_msgs]
    assert [tser.dumps(m) for m in port_msgs] == [
        tser.dumps(m) for m in _wal_messages("cometbft_tpu_torch")]
    paths = []
    for cls, msgs, name in ((RWAL, ref_msgs, "ref"),
                            (TWAL, port_msgs, "port")):
        wal = cls(str(tmp_path / name / "wal"))
        for i, m in enumerate(msgs):
            (wal.write_sync if i % 2 else wal.write)(m)
        wal.write_end_height(4)
        wal.close()
        paths.append(tmp_path / name / "wal")
    assert paths[1].read_bytes() == paths[0].read_bytes()
    # the reference's WAL decodes in the port, record for record
    port_wal = TWAL(str(paths[0]))
    try:
        got = list(port_wal.iter_messages())
        assert [tser.dumps(m) for m in got] == [
            tser.dumps(m) for m in [_end(0)] + port_msgs + [_end(4)]]
        # the records after marker 0, markers left out
        assert [tser.dumps(m) for m in port_wal.search_for_end_height(0)] \
            == [tser.dumps(m) for m in port_msgs[:-1]]
        assert port_wal.search_for_end_height(4) == []
        assert port_wal.search_for_end_height(9) is None
    finally:
        port_wal.close()


def _end(h):
    from cometbft_tpu_torch.consensus.wal import EndHeightMessage

    return EndHeightMessage(h)


def test_wal_torn_tail_and_rotation_as_the_reference(tmp_path):
    from cometbft_tpu.consensus.wal import WAL as RWAL
    from cometbft_tpu_torch.consensus.wal import WAL as TWAL

    out = []
    for cls, pkg in ((RWAL, "cometbft_tpu"), (TWAL, "cometbft_tpu_torch")):
        msgs = _wal_messages(pkg)
        path = str(tmp_path / pkg / "wal")
        wal = cls(path, head_size_limit=300)
        for m in msgs * 3:
            wal.write(m)
            wal.write_end_height(7)
        wal.close()
        with open(path, "ab") as f:
            f.write(b"\x01\x02\x03")  # a torn frame
        wal = cls(path)
        ser = pkg_module(pkg, "types.serialization")
        out.append(([ser.dumps(m) for m in wal.iter_messages()],
                    sorted(os.listdir(tmp_path / pkg)),
                    wal.search_for_end_height(7)))
        wal.close()
    assert out[1] == out[0]
    assert len(out[0][1]) > 2  # the group rotated


def test_converted_messages_and_config_round_trip():
    from cometbft_tpu import config as rconfig
    from cometbft_tpu.types import serialization as rser
    from cometbft_tpu_torch.types import serialization as tser

    for m in _wal_messages("cometbft_tpu"):
        assert tser.dumps(convert.message_from(m)) == rser.dumps(m)
        assert tser.dumps(tser.loads(rser.dumps(m))) == rser.dumps(m)
        inner = getattr(m, "msg", None)
        if inner is not None and hasattr(inner, "proposal"):
            assert convert.proposal_from(inner.proposal) == tser.loads(
                rser.dumps(inner.proposal))
    cfg = rconfig.test_config()
    cfg.mempool.size = 77
    got = convert.config_from(cfg)
    assert dataclasses.asdict(got.consensus) == dataclasses.asdict(
        cfg.consensus)
    assert dataclasses.asdict(got.mempool) == dataclasses.asdict(cfg.mempool)
    with pytest.raises(TypeError):
        convert.message_from(object())


# -- HeightVoteSet, TimeoutTicker ------------------------------------------


def _hvs_trace(pkg):
    t = pkg_module(pkg, "types")
    hvs_mod = pkg_module(pkg, "consensus.height_vote_set")
    genesis, pvs = make_signers(pkg)
    vals = genesis.validator_set()
    kw = {"device": "cpu"} if pkg == "cometbft_tpu_torch" else {}
    hvs = hvs_mod.HeightVoteSet(CHAIN_ID, 1, vals, **kw)
    out = [hvs.round(), hvs.prevotes(2) is None]
    hvs.set_round(1)
    out += [hvs.round(), hvs.prevotes(2) is not None]
    for rnd, idx, peer in ((0, 0, "p1"), (7, 1, "p1"), (8, 2, "p1"),
                           (9, 3, "p1"), (9, 3, "p2"), (2, 2, "p3")):
        vote = t.Vote(msg_type=t.PREVOTE_TYPE, height=1, round=rnd,
                      block_id=t.BlockID(b"\x05" * 32,
                                         t.PartSetHeader(1, b"\x06" * 32)),
                      timestamp_ns=T0, validator_address=vals.validators[
                          idx].address, validator_index=idx)
        pvs[idx].sign_vote(CHAIN_ID, vote, sign_extension=False)
        try:
            out.append(hvs.add_vote(vote, peer_id=peer))
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append(type(e).__name__)
    out.append(hvs.pol_info()[0])
    out.append(sorted(hvs._round_vote_sets))
    return out


def test_height_vote_set_catchup_rounds_as_the_reference():
    got = _hvs_trace("cometbft_tpu_torch")
    assert got == _hvs_trace("cometbft_tpu")
    assert "GotVoteFromUnwantedRoundError" in got


def _ticker_trace(pkg):
    ticker = pkg_module(pkg, "consensus.ticker")
    wal = pkg_module(pkg, "consensus.wal")
    out = []
    t = ticker.TimeoutTicker()
    t.start()
    try:
        t.schedule_timeout(wal.TimeoutInfo(5.0, 1, 0, 1))
        t.schedule_timeout(wal.TimeoutInfo(0.05, 1, 0, 2))  # replaces
        ti = t.tock_queue.get(timeout=2)
        out.append((ti.height, ti.round, ti.step))
        t.schedule_timeout(wal.TimeoutInfo(0.05, 5, 3, 4))
        t.schedule_timeout(wal.TimeoutInfo(0.01, 5, 2, 1))  # stale
        ti = t.tock_queue.get(timeout=2)
        out.append((ti.height, ti.round, ti.step))
        out.append(t.tock_queue.empty())
    finally:
        t.stop()
    return out


def test_timeout_ticker_as_the_reference():
    assert _ticker_trace("cometbft_tpu_torch") == _ticker_trace(
        "cometbft_tpu") == [(1, 0, 2), (5, 3, 4), True]


# -- the in-process net and restart (the port alone) ------------------------


def _chip_smoke():
    """chip_smoke.py, whose ConsensusNode wires a port node as
    cometbft_tpu/node/node.py does (stores, the ABCI handshake, mempool,
    evidence pool, executor, WAL, consensus, pipeline)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def port_node(genesis, pv, home=None):
    """A port node on the CPU (FileDBs and a WAL under ``home``, MemDBs
    without one), with the smoke burst's timeouts."""
    return SMOKE.ConsensusNode(genesis, pv, SMOKE.consensus_config(True),
                               home, device="cpu")


def wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_four_node_port_net_commits_three_heights(tmp_path):
    genesis, pvs = make_signers("cometbft_tpu_torch")
    nodes = [port_node(genesis, pv, str(tmp_path / f"n{i}"))
             for i, pv in enumerate(pvs)]
    SMOKE.wire_gossip(nodes)
    for n in nodes:
        for i in range(5):
            n.mempool.check_tx(b"net%d=%d" % (i, i))
    for n in nodes:
        n.cs.start()
    try:
        assert wait_for(lambda: min(n.block_store.height() for n in nodes)
                        >= 3 and all(n.mempool.size() == 0 for n in nodes))
        for h in (1, 2, 3):
            assert len({n.block_store.load_block(h).hash()
                        for n in nodes}) == 1
            assert len({n.state_store.load_finalize_block_response(h)
                        .app_hash for n in nodes}) == 1
        txs = [tx for h in (1, 2, 3) for tx in
               nodes[0].block_store.load_block(h).data.txs]
        assert sorted(txs) == sorted(b"net%d=%d" % (i, i) for i in range(5))
        assert all(not n.fatal for n in nodes)
    finally:
        for n in nodes:
            n.stop()


def test_restarted_node_replays_its_wal_and_catches_up(tmp_path):
    genesis, pvs = make_signers("cometbft_tpu_torch")
    genesis = dataclasses.replace(genesis, validators=genesis.validators[:1])
    pv = [p for p in pvs if p.get_pub_key() == genesis.validators[0]
          .pub_key][0]
    home = str(tmp_path / "node")
    node = port_node(genesis, pv, home)
    node.cs.start()
    try:
        assert wait_for(lambda: node.block_store.height() >= 2)
    finally:
        node.stop()  # mid-chain: no graceful height end
    # the app may lag the stores by a block: the handshake replays it
    node = port_node(genesis, pv, home)
    start = node.block_store.height()
    assert start >= 2
    assert node.app.info(None).last_block_height == start
    assert node.wal.search_for_end_height(start - 1) is not None
    node.cs.start()
    try:
        assert wait_for(lambda: node.state_store.load().last_block_height
                        >= start + 2)
        assert not node.fatal
        assert node.block_store.load_block(1).header.height == 1
    finally:
        node.stop()


# -- no fallback -----------------------------------------------------------


def _burst_node(n_vals=9, payload=None):
    """A sim-driven port node (CPU) of a ``n_vals``-validator chain that
    has entered round 0 of height 1 and taken its proposer's proposal;
    (node, signers, the block id). With ``payload``, the proposer signs a
    proposal whose parts carry those bytes instead of a block."""
    from cometbft_tpu_torch import types as t
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types import serialization as ser

    pvs = [t.MockPV(Ed25519PrivKey.from_seed(bytes([i + 40]) * 32))
           for i in range(n_vals)]
    genesis = t.GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0,
                           validators=[t.GenesisValidator(pv.get_pub_key(),
                                                          10) for pv in pvs])
    by = {bytes(pv.get_pub_key().address()): pv for pv in pvs}
    pvs = [by[v.address] for v in genesis.validator_set().validators]
    node = port_node(genesis, pvs[-1])
    cs = node.cs
    clock = Clock()
    cs._clock = clock
    cs.sim_driven = True
    cs.ticker = Ticker()
    cs.start()
    cs.process_pending()
    ti = cs.ticker.pending
    cs.ticker.pending = None
    cs._queue.put(("timeout", ti))
    cs.process_pending()
    proposer = cs.get_round_state().validators.get_proposer()
    blk = node.exe.create_proposal_block(1, cs.state, None,
                                         proposer.address,
                                         time_ns=clock.now_ns)
    ps = t.PartSet.from_data(ser.dumps(blk) if payload is None else payload)
    bid = t.BlockID(blk.hash(), ps.header)
    prop = t.Proposal(height=1, round=0, pol_round=-1, block_id=bid,
                      timestamp_ns=clock.now_ns)
    by[proposer.address].sign_proposal(CHAIN_ID, prop)
    cs.set_proposal_from_peer(prop, "peer")
    for part in ps.parts:
        cs.add_block_part_from_peer(1, 0, part, "peer")
    cs.process_pending()
    assert (cs.get_round_state().proposal_block is not None) == (
        payload is None)
    assert not node.fatal
    return node, pvs, bid


def _prevotes(pvs, bid):
    """The prevotes for ``bid`` of every signer but the node (the last)."""
    from cometbft_tpu_torch import types as t

    out = []
    for i, pv in enumerate(pvs[:-1]):
        vote = t.Vote(msg_type=t.PREVOTE_TYPE, height=1, round=0,
                      block_id=bid, timestamp_ns=T0 + 2 * 10**9 + i,
                      validator_address=bytes(pv.get_pub_key().address()),
                      validator_index=i)
        pv.sign_vote(CHAIN_ID, vote, sign_extension=False)
        out.append(vote)
    return out


def _failing_launch(monkeypatch):
    """Every K2/K1 launch of the port raises, as a failed kernel would."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import verify as ov

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(ov, "verify_rsk_async", boom)
    monkeypatch.setattr(ov, "verify_bytes_async", boom)
    monkeypatch.setattr(batch, "HOST_BATCH_THRESHOLD", 2)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})


def test_a_failing_launch_in_preverify_fail_stops_the_node(monkeypatch):
    node, pvs, bid = _burst_node()
    cs = node.cs
    try:
        _failing_launch(monkeypatch)
        for v in _prevotes(pvs, bid):
            cs.add_vote_from_peer(v, "peer")
        cs.process_pending()
        assert len(node.fatal) == 1
        assert "preverification" in str(node.fatal[0])
        assert isinstance(node.fatal[0].__cause__, RuntimeError)
        assert node.block_store.height() == 0
        # nothing was admitted by a host check in the card's place
        assert cs.get_round_state().votes.prevotes(0).sum == 10  # its own
    finally:
        node.stop()


def test_a_failing_launch_in_admission_fail_stops_the_node(monkeypatch):
    """Preverification skipped (as for a vote of another height): the
    vote's own check goes through a pushed coalescer whose window runs on
    the device, and its failed launch fail-stops the node."""
    from cometbft_tpu_torch.crypto import coalesce

    node, pvs, bid = _burst_node()
    cs = node.cs
    co = coalesce.VerifyCoalescer(device="cpu", min_device_lanes=1)
    co.start()
    coalesce.push_active(co)
    try:
        _failing_launch(monkeypatch)
        monkeypatch.setattr(cs, "_preverify_queued_votes", lambda items: None)
        cs.add_vote_from_peer(_prevotes(pvs, bid)[0], "peer")
        cs.process_pending()
        assert len(node.fatal) == 1 and "device path" in str(node.fatal[0])
        assert node.block_store.height() == 0
        assert cs.get_round_state().votes.prevotes(0).sum == 10
    finally:
        coalesce.pop_active(co)
        co.stop()
        node.stop()


def test_a_peer_error_is_still_dropped(monkeypatch):
    """A spoiled signature is the peer's fault: logged and dropped, the
    node runs on and commits."""
    node, pvs, bid = _burst_node(n_vals=4)
    cs = node.cs
    try:
        votes = _prevotes(pvs, bid)
        votes[0] = dataclasses.replace(votes[0], signature=b"\x01" * 64)
        for v in votes:
            cs.add_vote_from_peer(v, "peer")
        cs.process_pending()
        assert not node.fatal
        assert cs.get_round_state().votes.prevotes(0).get_by_index(0) is None
        assert cs.get_round_state().votes.prevotes(0).sum == 30
    finally:
        node.stop()


def test_a_proposal_of_nested_json_is_dropped_and_the_node_prevotes_nil():
    """A byzantine proposer signs a proposal whose parts assemble to JSON
    nested past the decoder's depth. Decoding it raises RecursionError, a
    RuntimeError that no plane marked: the node logs it and runs on, as the
    reference does, and at the propose timeout it prevotes nil."""
    from cometbft_tpu_torch.consensus.round_state import RoundStep

    depth = 100_000
    node, pvs, bid = _burst_node(
        n_vals=4, payload=b"[" * depth + b"]" * depth)
    cs = node.cs
    try:
        rs = cs.get_round_state()
        assert rs.proposal is not None and rs.proposal_block is None
        assert rs.proposal_block_parts.is_complete()
        ti = cs.ticker.pending
        assert ti.step == int(RoundStep.PROPOSE)
        cs.ticker.pending = None
        cs._queue.put(("timeout", ti))
        cs.process_pending()
        assert not node.fatal
        own = cs.get_round_state().votes.prevotes(0).get_by_index(
            len(pvs) - 1)
        assert own is not None and own.block_id.is_nil()
    finally:
        node.stop()


def test_device_faults_are_marked_where_they_leave_the_planes(monkeypatch):
    """What a batch verify, a prestage or a plane's window raises carries
    the device-fault mark through chained and re-raised exceptions, with
    its type unchanged; an error of the caller's own input does not."""
    from cometbft_tpu_torch.crypto import batch, coalesce
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.libs import devicefault

    assert devicefault.is_fault(RecursionError("peer json")) is None
    assert devicefault.is_fault(None) is None
    key = Ed25519PrivKey.from_seed(b"\x07" * 32)
    sig = key.sign(b"m")
    _failing_launch(monkeypatch)
    v = batch.Ed25519BatchVerifier(device="cpu")
    for _ in range(3):
        v.add(key.pub_key(), b"m", sig)
    with pytest.raises(RuntimeError) as ei:
        v.verify()
    assert type(ei.value) is RuntimeError
    assert devicefault.is_fault(ei.value) == "ed25519 batch verify"
    try:
        try:
            v.verify()
        except RuntimeError as e:
            raise ValueError("wrapped") from e
    except ValueError as e:
        assert devicefault.is_fault(e) == "ed25519 batch verify"

    co = coalesce.VerifyCoalescer(device="cpu", min_device_lanes=1)
    co.start()
    try:
        with pytest.raises(RuntimeError) as ei:
            co.try_verify([key.pub_key().data], [b"m"], [sig])
        assert devicefault.is_fault(ei.value)
        # a lane that does not coerce to bytes is its caller's error
        with pytest.raises(TypeError) as ei:
            co.try_verify([object()], [b"m"], [sig])
        assert devicefault.is_fault(ei.value) is None
    finally:
        co.stop()
    with pytest.raises(coalesce.CoalescerStoppedError) as ei:
        co.try_verify([key.pub_key().data], [b"m"], [sig])
    assert devicefault.is_fault(ei.value)


def test_a_failing_prestage_warm_up_is_raised_not_lost(monkeypatch):
    from cometbft_tpu_torch.consensus.pipeline import (CommitPipeline,
                                                       PipelineError)
    from cometbft_tpu_torch.consensus.state import FatalConsensusError
    from cometbft_tpu_torch.crypto import batch

    def boom(vals, device="cuda"):
        raise RuntimeError("KernelBuildError: nvcc failed")
    monkeypatch.setattr(batch, "prestage_validators", boom)
    node, pvs, bid = _burst_node(n_vals=4)
    for t in node.cs._prestage_threads:
        t.join(5)
    with pytest.raises(FatalConsensusError, match="prestage"):
        node.stop()
    # the pipeline's next-height warm-up alike
    pipe = CommitPipeline(None, None, device="cpu")
    pipe.prestage_next(node.cs.state.validators)
    for t in pipe._prestage_threads:
        t.join(5)
    with pytest.raises(PipelineError, match="nvcc failed"):
        pipe.prestage_next(node.cs.state.validators)


def test_consensus_state_defaults_to_cuda_and_raises_without_a_gpu():
    import torch

    from cometbft_tpu_torch.consensus import ConsensusState

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ConsensusState(None, None, None, None)
